"""Classification/regression + RDF REST endpoints.

A copy of the JAX package's ``oryx_tpu/serving/resources/classreg.py``
(host code, no JAX), held equal to it over HTTP too, by ``tests/test_torch_rdf.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's classreg and rdf resources
(app/oryx-app-serving/.../classreg/Predict.java:51-99, Train.java:41-52,
rdf/ClassificationDistribution.java:52-77, rdf/FeatureImportance.java:45-69):
/predict returns the forest vote per datum line (category value or numeric
score); /train appends training data to the input topic;
/classificationDistribution returns per-class probabilities as IDValues;
/feature/importance returns forest importances.
"""

from __future__ import annotations

from aiohttp import web

from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.serving import resource as rsrc
from oryx_tpu_torch.serving.resource import check


def _predict_one(request: web.Request, datum: str) -> str:
    check(bool(datum), "Missing input data")
    model = rsrc.get_serving_model(request)
    tokens = textutils.parse_delimited(datum)
    try:
        return model.predict(tokens)
    except (ValueError, KeyError, IndexError) as e:
        raise rsrc.OryxServingException(400, f"bad datum: {datum}") from e


async def predict_get(request: web.Request) -> web.Response:
    return web.Response(
        text=_predict_one(request, request.match_info["datum"]),
        content_type="text/plain",
    )


async def predict_post(request: web.Request) -> web.Response:
    lines = await rsrc.read_body_lines(request)
    check(bool(lines), "Missing input data")
    predictions = [_predict_one(request, line) for line in lines]
    return rsrc.render(request, predictions)


async def train_datum(request: web.Request) -> web.Response:
    await rsrc.send_input_async(request, request.match_info["datum"])
    return web.Response(status=204)


async def train_body(request: web.Request) -> web.Response:
    lines = await rsrc.read_body_lines(request)
    check(bool(lines), "Missing input data")
    await rsrc.send_input_many(request, lines)
    return web.Response(status=204)


async def classification_distribution(request: web.Request) -> web.Response:
    datum = request.match_info["datum"]
    check(bool(datum), "Missing input data")
    model = rsrc.get_serving_model(request)
    schema = model.input_schema
    check(schema.is_classification(), "Only applicable for classification")
    try:
        prediction = model.make_prediction(textutils.parse_delimited(datum))
    except (ValueError, KeyError, IndexError) as e:
        raise rsrc.OryxServingException(400, f"bad datum: {datum}") from e
    probabilities = prediction.category_probabilities
    e2v = model.encodings.get_encoding_value_map(schema.target_feature_index)
    return rsrc.render(
        request,
        [rsrc.id_value(e2v[i], float(p)) for i, p in enumerate(probabilities)],
    )


async def feature_importance(request: web.Request) -> web.Response:
    model = rsrc.get_serving_model(request)
    importances = [float(v) for v in model.forest.feature_importances]
    return rsrc.render(request, importances)


async def feature_importance_one(request: web.Request) -> web.Response:
    model = rsrc.get_serving_model(request)
    importances = model.forest.feature_importances
    try:
        n = int(request.match_info["featureNumber"])
    except ValueError as e:
        raise rsrc.OryxServingException(400, "Bad feature number") from e
    check(0 <= n < len(importances), "Bad feature number")
    return web.Response(text=str(float(importances[n])), content_type="text/plain")


def register(app: web.Application) -> None:
    app.router.add_route("GET", "/predict/{datum}", predict_get)
    app.router.add_route("POST", "/predict", predict_post)
    app.router.add_route("POST", "/train/{datum}", train_datum)
    app.router.add_route("POST", "/train", train_body)
    app.router.add_route(
        "GET", "/classificationDistribution/{datum}", classification_distribution
    )
    app.router.add_route("GET", "/feature/importance", feature_importance)
    app.router.add_route(
        "GET", "/feature/importance/{featureNumber}", feature_importance_one
    )

    from oryx_tpu_torch.serving.console import register_console

    register_console(app, "Oryx classification/regression serving layer", [
        ("GET", "/predict/{datum}", "forest vote for one datum"),
        ("POST", "/predict", "forest votes, one per body line"),
        ("POST", "/train/{datum}", "append one training example"),
        ("POST", "/train", "append training examples from the body"),
        ("GET", "/classificationDistribution/{datum}", "per-class probabilities"),
        ("GET", "/feature/importance", "all feature importances"),
        ("GET", "/feature/importance/{n}", "one feature's importance"),
        ("GET", "/metrics", "Prometheus metrics exposition"),
        ("GET", "/trace", "recent + slowest-per-route request traces"),
        ("GET", "/healthz", "liveness probe"),
        ("GET", "/readyz", "readiness probe (model loaded + update lag)"),
    ])
