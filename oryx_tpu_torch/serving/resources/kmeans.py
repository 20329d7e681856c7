"""Clustering REST endpoints: /assign, /distanceToNearest, /add.

A copy of the JAX package's ``oryx_tpu/serving/resources/kmeans.py`` (host
code, no JAX), held to it over HTTP by ``tests/test_torch_serving.py``.

Equivalent of the reference's clustering resources
(app/oryx-app-serving/.../clustering/Assign.java:51-55,
kmeans/DistanceToNearest.java:39, clustering/Add.java:42-53): a datum is a
delimited line like ``1,-4,3.0``; /assign returns the nearest cluster ID (one
per input line on POST), /distanceToNearest the distance to the closest
center, /add appends data points to the input topic. Scalar responses are
text/plain like the reference.
"""

from __future__ import annotations

from aiohttp import web

from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.models import pmml_common
from oryx_tpu_torch.serving import resource as rsrc
from oryx_tpu_torch.serving.resource import check

# the clustering family reuses a single concrete model: k-means


def _nearest(request: web.Request, datum: str) -> tuple[int, float]:
    check(bool(datum), "Data is needed to cluster")
    model = rsrc.get_serving_model(request)
    tokens = textutils.parse_delimited(datum)
    try:
        vec = pmml_common.features_from_tokens(tokens, model.input_schema)
    except (ValueError, IndexError) as e:
        raise rsrc.OryxServingException(400, f"bad datum: {datum}") from e
    return model.nearest_cluster(vec)


async def assign_get(request: web.Request) -> web.Response:
    cluster_id, _ = _nearest(request, request.match_info["datum"])
    return web.Response(text=str(cluster_id), content_type="text/plain")


async def assign_post(request: web.Request) -> web.Response:
    lines = await rsrc.read_body_lines(request)
    check(bool(lines), "Data is needed to cluster")
    ids = [str(_nearest(request, line)[0]) for line in lines]
    return web.Response(text="\n".join(ids) + "\n", content_type="text/plain")


async def distance_to_nearest(request: web.Request) -> web.Response:
    _, dist = _nearest(request, request.match_info["datum"])
    return web.Response(text=str(dist), content_type="text/plain")


async def add_datum(request: web.Request) -> web.Response:
    await rsrc.send_input_async(request, request.match_info["datum"])
    return web.Response(status=204)


async def add_body(request: web.Request) -> web.Response:
    lines = await rsrc.read_body_lines(request)
    check(bool(lines), "Data is needed")
    await rsrc.send_input_many(request, lines)
    return web.Response(status=204)


def register(app: web.Application) -> None:
    app.router.add_route("GET", "/assign/{datum}", assign_get)
    app.router.add_route("POST", "/assign", assign_post)
    app.router.add_route("GET", "/distanceToNearest/{datum}", distance_to_nearest)
    app.router.add_route("POST", "/add/{datum}", add_datum)
    app.router.add_route("POST", "/add", add_body)

    from oryx_tpu_torch.serving.console import register_console

    register_console(app, "Oryx clustering serving layer", [
        ("GET", "/assign/{datum}", "nearest cluster ID for a datum"),
        ("POST", "/assign", "nearest cluster IDs, one per body line"),
        ("GET", "/distanceToNearest/{datum}", "distance to the closest center"),
        ("POST", "/add/{datum}", "append a data point"),
        ("POST", "/add", "append data points from the body"),
        ("GET", "/metrics", "Prometheus metrics exposition"),
        ("GET", "/trace", "recent + slowest-per-route request traces"),
        ("GET", "/healthz", "liveness probe"),
        ("GET", "/readyz", "readiness probe (model loaded + update lag)"),
    ])
