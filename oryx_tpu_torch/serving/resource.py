"""Serving resource plumbing: readiness gating, input sending, rendering.

A copy of the JAX package's ``oryx_tpu/serving/resource.py`` (host code, no
JAX), held to it over HTTP by ``tests/test_torch_serving.py``.

Equivalent of the reference's AbstractOryxResource + CSVMessageBodyWriter +
OryxExceptionMapper (app/oryx-app-serving/.../AbstractOryxResource.java:58-182,
framework/oryx-lambda-serving/.../CSVMessageBodyWriter.java:33-41): handlers
pull the model manager and input producer out of the app context, gate on
``min-model-load-fraction`` (503 until loaded), send input keyed by a hex hash
of the message, and render responses as JSON or CSV by Accept header.
"""

from __future__ import annotations

import asyncio
import gzip
import hashlib
import io
import zipfile
from typing import Any

from aiohttp import web

from oryx_tpu_torch.api.serving import OryxServingException
from oryx_tpu_torch.common import resilience
from oryx_tpu_torch.common import spans

log = spans.get_logger(__name__)

MANAGER_KEY = "oryx.model-manager"
INPUT_PRODUCER_KEY = "oryx.input-producer"
CONFIG_KEY = "oryx.config"
COALESCER_KEY = "oryx.top-n-coalescer"


def get_manager(request: web.Request):
    return request.app[MANAGER_KEY]


def get_serving_model(request: web.Request):
    """Readiness gate (AbstractOryxResource.getServingModel:75-97)."""
    manager = get_manager(request)
    config = request.app[CONFIG_KEY]
    min_fraction = config.get_float("oryx.serving.min-model-load-fraction")
    model = manager.get_model()
    if model is not None and model.get_fraction_loaded() >= min_fraction:
        return model
    raise OryxServingException(503, "model not yet available; try again soon")


def send_input(request: web.Request, message: str) -> None:
    """Write to the input topic, key = hex hash of message
    (AbstractOryxResource.sendInput:65-69).

    Synchronous — on ``file:`` brokers the send does file I/O under the
    broker lock, so async handlers must use :func:`send_input_async` /
    :func:`send_input_many` instead of calling this on the event loop
    (oryx-analyze: blocking-async)."""
    manager = get_manager(request)
    if manager.is_read_only():
        raise OryxServingException(403, "serving layer is read-only")
    producer = request.app.get(INPUT_PRODUCER_KEY)
    if producer is None:
        raise OryxServingException(503, "no input producer")
    key = format(int.from_bytes(hashlib.md5(message.encode()).digest()[:4], "big"), "08x")
    producer.send(key, message)


async def send_input_async(request: web.Request, message: str) -> None:
    """send_input off the event loop (one executor hop per message).

    ``asyncio.to_thread`` — NOT ``run_in_executor``, which drops contextvars
    on this Python — so the producer in the worker thread still sees the
    request's ingress span and stamps the message's traceparent header:
    span continuity across the executor."""
    await asyncio.to_thread(send_input, request, message)


async def send_input_many(request: web.Request, messages: "list[str]") -> None:
    """Bulk send in ONE executor hop — /ingest-sized bodies would otherwise
    pay a loop→executor round-trip per line."""

    def send_all() -> None:
        for m in messages:
            send_input(request, m)

    await asyncio.to_thread(send_all)


def check(condition: bool, message: str, status: int = 400) -> None:
    """(AbstractOryxResource.check:134-154)"""
    if not condition:
        raise OryxServingException(status, message)


def check_exists(value, what: str) -> Any:
    if value is None:
        raise OryxServingException(404, f"{what} not found")
    return value


# ---------------------------------------------------------------------------
# Rendering: JSON default, CSV on Accept: text/csv
# ---------------------------------------------------------------------------


def _to_csv_row(item: Any) -> str:
    from oryx_tpu_torch.common import textutils

    if isinstance(item, dict):
        return textutils.join_delimited(list(item.values()))
    if isinstance(item, (list, tuple)):
        return textutils.join_delimited(item)
    return str(item)


def render(request: web.Request, payload: Any, status: int = 200) -> web.Response:
    accept = request.headers.get("Accept", "")
    if "text/csv" in accept:
        if payload is None:
            body = ""
        elif isinstance(payload, (list, tuple)):
            body = "\n".join(_to_csv_row(i) for i in payload)
            if body:
                body += "\n"
        else:
            body = _to_csv_row(payload) + "\n"
        return web.Response(text=body, status=status, content_type="text/csv")
    return web.json_response(payload, status=status)


def id_value(id_: str, value: float) -> dict:
    """IDValue response type (app/serving/IDValue.java)."""
    return {"id": id_, "value": value}


def id_count(id_: str, count: int) -> dict:
    return {"id": id_, "count": count}


# ---------------------------------------------------------------------------
# Request helpers
# ---------------------------------------------------------------------------


def get_how_many_offset(request: web.Request) -> tuple[int, int]:
    how_many = int(request.query.get("howMany", "10"))
    offset = int(request.query.get("offset", "0"))
    check(how_many > 0, "howMany must be positive")
    check(offset >= 0, "offset must be non-negative")
    return how_many, offset


def get_rescorer_params(request: web.Request) -> list[str]:
    return request.query.getall("rescorerParams", [])


def split_path_list(rest: str) -> list[str]:
    """Parse multi-segment path lists like /similarity/i1/i2/i3."""
    from urllib.parse import unquote

    parts = [unquote(p) for p in rest.split("/") if p != ""]
    check(bool(parts), "path requires at least one value")
    return parts


def parse_id_value_pairs(parts: list[str]) -> list[tuple[str, float]]:
    """itemID=value path segments, value defaulting to 1
    (RecommendToAnonymous/EstimateForAnonymous semantics)."""
    out = []
    for p in parts:
        if "=" in p:
            id_, v = p.split("=", 1)
            try:
                out.append((id_, float(v)))
            except ValueError as e:
                raise OryxServingException(400, f"bad value in {p}") from e
        else:
            out.append((p, 1.0))
    return out


async def read_body_lines(request: web.Request) -> list[str]:
    """Request body → lines, handling gzip/zip and multipart form data
    (AbstractOryxResource.java:99-132,164-179)."""
    content_type = request.headers.get("Content-Type", "")
    if content_type.startswith("multipart/"):
        lines: list[str] = []
        reader = await request.multipart()
        async for part in reader:
            data = await part.read(decode=False)
            lines.extend(_decode_maybe_compressed(data, part.headers.get("Content-Type", "")))
        return lines
    data = await request.read()
    return _decode_maybe_compressed(data, content_type)


def _decode_maybe_compressed(data: bytes, content_type: str) -> list[str]:
    # sniff by magic bytes: aiohttp already transparently decompresses
    # Content-Encoding bodies, so the header alone is not trustworthy
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    elif "zip" in content_type or data[:4] == b"PK\x03\x04":
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            chunks = [zf.read(n) for n in zf.namelist()]
        data = b"\n".join(chunks)
    text = data.decode("utf-8", errors="replace")
    return [line for line in text.splitlines() if line.strip()]


@web.middleware
async def error_middleware(request: web.Request, handler):
    """OryxServingException → HTTP status (OryxExceptionMapper). Shed
    requests (OverloadedException) additionally carry a ``Retry-After``
    hint; an expired request deadline maps to 504 with the partial trace
    id, so the operator can pull up exactly how far the request got."""
    try:
        return await handler(request)
    except OryxServingException as e:
        headers = {}
        retry_after = getattr(e, "retry_after_sec", None)
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(retry_after)))
        accept = request.headers.get("Accept", "")
        if "text/csv" in accept:
            return web.Response(text=e.message, status=e.status,
                                content_type="text/plain", headers=headers)
        return web.json_response({"error": e.message, "status": e.status},
                                 status=e.status, headers=headers)
    except resilience.DeadlineExceeded as e:
        return web.json_response({
            "error": str(e) or "request deadline exceeded",
            "status": 504,
            # the PARTIAL trace: every span recorded before the budget ran
            # out is already in the ring, retrievable by this id
            "trace_id": spans.current_trace_id(),
        }, status=504)
    except web.HTTPException:
        raise
    except Exception as e:  # noqa: BLE001 - uniform 500 mapping
        log.exception("unhandled error in %s", request.path)
        return web.json_response({"error": str(e), "status": 500}, status=500)
