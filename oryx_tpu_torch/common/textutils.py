"""Line codecs the input pipelines and the update topic need: CSV
(RFC-4180 quoting) or a JSON array per line, and the JSON join/read of the
k-means ``UP`` messages. A copy of the reference's ``common/textutils``
codec functions (TextUtils.java:56-189 in the original Oryx)."""

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
