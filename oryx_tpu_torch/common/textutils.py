"""Line codecs the ALS input pipeline needs: CSV (RFC-4180 quoting) or a
JSON array per line. A copy of the reference's ``common/textutils`` parsing
functions (TextUtils.java:56-189 in the original Oryx)."""

from __future__ import annotations

import csv
import io
import json
from typing import Any


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


def parse_possibly_json(line: str) -> list[str]:
    """Input lines may be CSV or a JSON array; sniff and parse."""
    stripped = line.strip()
    if stripped.startswith("["):
        return parse_json_array(stripped)
    return parse_csv(line)
