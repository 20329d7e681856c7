"""Word-count example endpoints: /distinct and /add.

A copy of the JAX package's ``oryx_tpu/example/resources.py`` on the port's
serving app. Equivalent of the reference's example serving resources
(app/example/.../serving/Distinct.java, Add.java): /distinct returns the full
word→count map (or one word's count, 400 for unknown words); /add appends
lines of text to the input topic.
"""

from __future__ import annotations

from aiohttp import web

from oryx_tpu_torch.serving import resource as rsrc


async def distinct_all(request: web.Request) -> web.Response:
    model = rsrc.get_serving_model(request)
    return web.json_response(model.get_words())


async def distinct_word(request: web.Request) -> web.Response:
    model = rsrc.get_serving_model(request)
    count = model.get_words().get(request.match_info["word"])
    rsrc.check(count is not None, "No such word")
    return web.Response(text=str(count), content_type="text/plain")


async def add_line(request: web.Request) -> web.Response:
    await rsrc.send_input_async(request, request.match_info["line"])
    return web.Response(status=204)


async def add_body(request: web.Request) -> web.Response:
    lines = await rsrc.read_body_lines(request)
    rsrc.check(bool(lines), "Missing input")
    await rsrc.send_input_many(request, lines)
    return web.Response(status=204)


def register(app: web.Application) -> None:
    app.router.add_get("/distinct", distinct_all)
    app.router.add_get("/distinct/{word}", distinct_word)
    app.router.add_post("/add/{line}", add_line)
    app.router.add_post("/add", add_body)

    from oryx_tpu_torch.serving.console import register_console

    register_console(app, "Oryx word-count example", [
        ("GET", "/distinct", "word → distinct co-word counts"),
        ("GET", "/distinct/{word}", "one word's count"),
        ("POST", "/add/{line}", "append a line of text"),
        ("POST", "/add", "append lines from the body"),
        ("GET", "/metrics", "Prometheus metrics exposition"),
        ("GET", "/trace", "recent + slowest-per-route request traces"),
        ("GET", "/healthz", "liveness probe"),
        ("GET", "/readyz", "readiness probe (model loaded + update lag)"),
    ])
