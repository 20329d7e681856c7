"""Line codecs the input pipelines and the update topic need: CSV
(RFC-4180 quoting) or a JSON array per line, and the JSON join/read of the
k-means and RDF ``UP`` messages, and the fleet console's sparkline. A copy
of the reference's ``common/textutils`` codec functions (TextUtils.java:56-189
in the original Oryx) and of ``sparkline``."""

from __future__ import annotations

import csv
import io
import json
from typing import Any, Sequence


def parse_delimited(line: str, delimiter: str = ",") -> list[str]:
    reader = csv.reader(io.StringIO(line), delimiter=delimiter, quotechar='"')
    row = next(reader, [])
    return list(row)


def parse_csv(line: str) -> list[str]:
    return parse_delimited(line, ",")


def parse_json_array(line: str) -> list[str]:
    arr = json.loads(line)
    if not isinstance(arr, list):
        raise ValueError(f"not a JSON array: {line!r}")
    return [_tok(v) for v in arr]


def _tok(v: Any) -> str:
    if isinstance(v, str):
        return v
    return json.dumps(v)


def join_delimited(values: Sequence[Any], delimiter: str = ",") -> str:
    buf = io.StringIO()
    writer = csv.writer(buf, delimiter=delimiter, quotechar='"', lineterminator="")
    writer.writerow(["" if v is None else v for v in values])
    return buf.getvalue()


def join_json(values: Sequence[Any]) -> str:
    return json.dumps(list(values), separators=(",", ":"))


def read_json(s: str, cls: type | None = None) -> Any:
    v = json.loads(s)
    if cls is not None and not isinstance(v, cls):
        raise ValueError(f"expected {cls.__name__}, got {type(v).__name__}")
    return v


def parse_possibly_json(line: str) -> list[str]:
    """Input lines may be CSV or a JSON array; sniff and parse."""
    stripped = line.strip()
    if stripped.startswith("["):
        return parse_json_array(stripped)
    return parse_csv(line)


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[Any], width: int = 8) -> str:
    """Render the last ``width`` numeric values as a unicode sparkline.

    Non-numeric entries and NaNs are skipped; an empty/all-bad input renders
    ``""``. A flat series renders the baseline glyph so "no data" and
    "constant data" stay visually distinct. Used by the fleet-status table
    to show /metrics/history series inline.
    """
    vals = [
        float(v) for v in values
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v == v
    ][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_CHARS[0] * len(vals)
    top = len(_SPARK_CHARS) - 1
    return "".join(
        _SPARK_CHARS[min(top, int((v - lo) / (hi - lo) * (top + 1)))]
        for v in vals
    )
