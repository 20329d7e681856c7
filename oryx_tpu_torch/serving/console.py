"""Embedded HTML console served at the context root.

A copy of the JAX package's ``oryx_tpu/serving/console.py`` (host code, no
JAX), held to it over HTTP by ``tests/test_torch_serving.py``.

Equivalent of the reference's AbstractConsoleResource + per-app Console
classes (app/oryx-app-serving/.../AbstractConsoleResource.java:36-60,
als/Console.java, kmeans/Console.java, rdf/Console.java): each app family
serves a small self-contained HTML page at ``/`` for poking its endpoints
from a browser. Where the reference ships static resource files, this renders
the page from the app's endpoint table so it never drifts from the routes.
"""

from __future__ import annotations

import html

from aiohttp import web

_PAGE = """<!DOCTYPE html>
<html>
<head><title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
h1 {{ font-size: 1.4em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #ccc; padding: 4px 10px; text-align: left; }}
code {{ background: #f4f4f4; padding: 1px 4px; }}
form {{ margin: 0; }}
</style></head>
<body>
<h1>{title}</h1>
<p>Model status: <a href="ready">/ready</a></p>
<table>
<tr><th>Method</th><th>Endpoint</th><th>Description</th><th>Try</th></tr>
{rows}
</table>
</body></html>
"""

_ROW = (
    "<tr><td>{method}</td><td><code>{path}</code></td><td>{doc}</td>"
    "<td>{form}</td></tr>"
)


def make_console(title: str, endpoints: "list[tuple[str, str, str]]"):
    """Build the `/` handler from (method, path, description) rows."""
    rows = []
    for method, path, doc in endpoints:
        form = ""
        if method == "GET" and "{" not in path:
            form = f'<a href="{html.escape(path.lstrip("/"))}">open</a>'
        rows.append(
            _ROW.format(
                method=html.escape(method),
                path=html.escape(path),
                doc=html.escape(doc),
                form=form,
            )
        )
    page = _PAGE.format(title=html.escape(title), rows="\n".join(rows))

    async def console(request: web.Request) -> web.Response:
        return web.Response(text=page, content_type="text/html")

    return console


def register_console(
    app: web.Application, title: str, endpoints: "list[tuple[str, str, str]]"
) -> None:
    app.router.add_get("/", make_console(title, endpoints))
