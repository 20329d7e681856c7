"""PMML 4.3 codec — the model interchange format for all model families.

A copy of the JAX package's
``oryx_tpu/pmml/pmmlutils.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's PMMLUtils + the extension helpers of AppPMMLUtils
(framework/oryx-common/.../pmml/PMMLUtils.java:47-135,
app/oryx-app-common/.../pmml/AppPMMLUtils.java:66-125). Artifacts are plain
PMML 4.3 XML; Oryx-specific payloads (ALS factor dir names, ID lists,
hyperparameters) ride in ``<Extension>`` elements on the PMML root, with list
content encoded as PMML Array text: space-separated, values quoted with ``"``
and embedded quotes escaped ``\\"`` (TextUtils.joinPMMLDelimited).

A model written by the reference's ALS/k-means/RDF pipelines parses here and
vice versa — the wire format is part of the capability surface.
"""

from __future__ import annotations

import datetime
import io
import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Sequence

PMML_NAMESPACE = "http://www.dmg.org/PMML-4_3"
PMML_VERSION = "4.3"  # PMMLUtils.java:47

ET.register_namespace("", PMML_NAMESPACE)


def _q(tag: str) -> str:
    return f"{{{PMML_NAMESPACE}}}{tag}"


# ---------------------------------------------------------------------------
# PMML-delimited text (space-separated with quoting) — TextUtils.joinPMMLDelimited
# ---------------------------------------------------------------------------

_NEEDS_QUOTE_RE = re.compile(r'[\s"]')


def join_pmml_delimited(values: Sequence) -> str:
    out = []
    for v in values:
        s = str(v)
        if _NEEDS_QUOTE_RE.search(s) or s == "":
            s = '"' + s.replace('"', '\\"') + '"'
        out.append(s)
    return " ".join(out)


def parse_pmml_delimited(text: str) -> list[str]:
    tokens: list[str] = []
    i, n = 0, len(text)
    while i < n:
        if text[i].isspace():
            i += 1
            continue
        if text[i] == '"':
            i += 1
            buf = []
            while i < n:
                if text[i] == "\\" and i + 1 < n and text[i + 1] == '"':
                    buf.append('"')
                    i += 2
                elif text[i] == '"':
                    i += 1
                    break
                else:
                    buf.append(text[i])
                    i += 1
            tokens.append("".join(buf))
        else:
            j = i
            while j < n and not text[j].isspace():
                j += 1
            tokens.append(text[i:j])
            i = j
    return tokens


# ---------------------------------------------------------------------------
# Document skeleton + IO (PMMLUtils)
# ---------------------------------------------------------------------------


def build_skeleton_pmml() -> ET.Element:
    """Root with Header/Application/Timestamp (PMMLUtils.buildSkeletonPMML:55)."""
    root = ET.Element(_q("PMML"), {"version": PMML_VERSION})
    header = ET.SubElement(root, _q("Header"))
    ET.SubElement(header, _q("Application"), {"name": "OryxTPU", "version": "0.1.0"})
    ts = ET.SubElement(header, _q("Timestamp"))
    ts.text = datetime.datetime.now(datetime.timezone.utc).isoformat()
    return root


def write(pmml: ET.Element, path: "str | Path") -> None:
    ET.ElementTree(pmml).write(path, encoding="utf-8", xml_declaration=True)


def read(path: "str | Path") -> ET.Element:
    return ET.parse(path).getroot()


def to_string(pmml: ET.Element) -> str:
    buf = io.BytesIO()
    ET.ElementTree(pmml).write(buf, encoding="utf-8", xml_declaration=False)
    return buf.getvalue().decode("utf-8")


def from_string(s: str) -> ET.Element:
    return ET.fromstring(s)


def find(pmml: ET.Element, tag: str) -> "ET.Element | None":
    """Find first descendant by local tag name, namespace-agnostic (the
    reference reads PMML written by either Oryx or other producers)."""
    for el in pmml.iter():
        if el.tag.rsplit("}", 1)[-1] == tag:
            return el
    return None


def find_all(pmml: ET.Element, tag: str) -> list[ET.Element]:
    return [el for el in pmml.iter() if el.tag.rsplit("}", 1)[-1] == tag]


def subelement(parent: ET.Element, tag: str, attrib: dict | None = None) -> ET.Element:
    return ET.SubElement(parent, _q(tag), {k: str(v) for k, v in (attrib or {}).items()})


# ---------------------------------------------------------------------------
# Extensions (AppPMMLUtils:66-125)
# ---------------------------------------------------------------------------


def add_extension(pmml: ET.Element, key: str, value) -> None:
    ext = ET.Element(_q("Extension"), {"name": key, "value": str(value)})
    pmml.insert(_n_header_children(pmml), ext)


def add_extension_content(pmml: ET.Element, key: str, content: Sequence) -> None:
    if not content:
        return
    ext = ET.Element(_q("Extension"), {"name": key})
    ext.text = join_pmml_delimited(content)
    pmml.insert(_n_header_children(pmml), ext)


def _n_header_children(pmml: ET.Element) -> int:
    # extensions go right after Header, before models
    for i, child in enumerate(pmml):
        if child.tag.rsplit("}", 1)[-1] == "Header":
            return i + 1
    return 0


def _extensions(pmml: ET.Element):
    for el in pmml:
        if el.tag.rsplit("}", 1)[-1] == "Extension":
            yield el


def get_extension_value(pmml: ET.Element, name: str) -> "str | None":
    for el in _extensions(pmml):
        if el.get("name") == name:
            return el.get("value")
    return None


def get_extension_content(pmml: ET.Element, name: str) -> "list[str] | None":
    for el in _extensions(pmml):
        if el.get("name") == name:
            return parse_pmml_delimited(el.text or "")
    return None
