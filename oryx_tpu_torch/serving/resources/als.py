"""ALS REST endpoints — the full recommender API surface.

A copy of the JAX package's ``oryx_tpu/serving/resources/als.py`` (host
code, no JAX), held to it over HTTP by ``tests/test_torch_serving.py``. The
cosines of ``/similarityToItem`` and ``/because`` run as one product on the
model's device. The manager's ``rescorer_provider`` (from
``oryx.als.rescorer-provider-class``) supplies the per-request hooks; a
request whose rescorer rewrites scores takes the model's single-query
``top_n``, every other recommend-family request the coalescer.

Equivalent of the reference's app/oryx-app-serving ALS resources (SURVEY §2.11
endpoint inventory; per-class citations inline). Handlers are async; device
calls (top-N matmuls) run in the default executor so the event loop never
blocks on the accelerator.

All endpoints produce JSON (default) or CSV (Accept: text/csv).
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
from aiohttp import web

from oryx_tpu_torch.api.serving import OryxServingException
from oryx_tpu_torch.common import textutils
from oryx_tpu_torch.ops import vectormath as vm
from oryx_tpu_torch.serving import resource as rsrc
from oryx_tpu_torch.serving.resource import (
    check,
    check_exists,
    get_how_many_offset,
    get_rescorer_params,
    id_count,
    id_value,
    parse_id_value_pairs,
    render,
    split_path_list,
)


def _als_model(request: web.Request):
    return rsrc.get_serving_model(request)


def _rescorer_provider(request: web.Request):
    return getattr(rsrc.get_manager(request), "rescorer_provider", None)


async def _run(request, fn, *args):
    # to_thread (not run_in_executor) carries contextvars: device work in
    # the worker keeps the request's ingress span current, so spans opened
    # inside (and any histogram exemplars) land in the right trace
    return await asyncio.to_thread(fn, *args)


async def _top_n(request, model, vec, how_many, offset, allowed, rescore,
                 excluded):
    """Recommend-family top-N: coalesced into one batched device call with
    concurrent requests when no score-rewriting rescorer applies (a shared
    scan cannot honor per-request rescore hooks).

    Degraded mode: while the device-call circuit breaker is OPEN
    (``coalescer.admit()`` false), requests bypass the coalescer and run
    per-request scans on the current model — slower, but answering — until
    a half-open probe through the coalesced path closes the breaker."""
    coalescer = request.app.get(rsrc.COALESCER_KEY)
    if coalescer is not None and rescore is None and coalescer.admit():
        return await coalescer.top_n(model, vec, how_many, offset, allowed,
                                     excluded)
    return await _run(
        request,
        lambda: model.top_n(vec, how_many, offset, allowed, rescore,
                            excluded=excluded),
    )


def _combine_allowed_rescore(allowed, rescorer):
    if rescorer is None:
        return allowed, None
    base_allowed = allowed

    def allowed2(id_):
        if base_allowed is not None and not base_allowed(id_):
            return False
        return not rescorer.is_filtered(id_)

    return allowed2, rescorer.rescore


# ---------------------------------------------------------------------------
# Recommendation endpoints
# ---------------------------------------------------------------------------


async def recommend(request: web.Request) -> web.Response:
    """GET /recommend/{userID} (als/Recommend.java:68-114)."""
    model = _als_model(request)
    user = request.match_info["userID"]
    how_many, offset = get_how_many_offset(request)
    consider_known = request.query.get("considerKnownItems", "false") == "true"
    uv = check_exists(model.get_user_vector(user), user)
    # known-item filtering rides the scan as a device-side mask (the sharded
    # path needs no host fallback); rescorer hooks stay host-side callables
    known = set() if consider_known else model.get_known_items(user)
    provider = _rescorer_provider(request)
    rescorer = (
        provider.get_recommend_rescorer([user], get_rescorer_params(request))
        if provider
        else None
    )
    allowed, rescore = _combine_allowed_rescore(None, rescorer)
    results = await _top_n(
        request, model, uv, how_many, offset, allowed, rescore, known
    )
    return render(request, [id_value(i, s) for i, s in results])


async def recommend_to_many(request: web.Request) -> web.Response:
    """GET /recommendToMany/{userID...} — mean of user vectors
    (als/RecommendToMany.java:56)."""
    model = _als_model(request)
    users = split_path_list(request.match_info["userIDs"])
    how_many, offset = get_how_many_offset(request)
    consider_known = request.query.get("considerKnownItems", "false") == "true"
    vectors = [v for u in users if (v := model.get_user_vector(u)) is not None]
    check(bool(vectors), "no known users", 404)
    mean_vec = np.mean(vectors, axis=0)
    known: set[str] = set()
    if not consider_known:
        for u in users:
            known |= model.get_known_items(u)
    provider = _rescorer_provider(request)
    rescorer = (
        provider.get_recommend_rescorer(users, get_rescorer_params(request))
        if provider
        else None
    )
    allowed, rescore = _combine_allowed_rescore(None, rescorer)
    results = await _top_n(
        request, model, mean_vec, how_many, offset, allowed, rescore, known
    )
    return render(request, [id_value(i, s) for i, s in results])


async def recommend_to_anonymous(request: web.Request) -> web.Response:
    """GET /recommendToAnonymous/{itemID=value...} — fold-in synthesized user
    (als/RecommendToAnonymous.java:58)."""
    model = _als_model(request)
    pairs = parse_id_value_pairs(split_path_list(request.match_info["items"]))
    how_many, offset = get_how_many_offset(request)
    vec = await _run(request, lambda: model.build_temporary_user_vector(pairs))
    check(vec is not None, "no solver available for model yet", 503)
    context_items = {i for i, _ in pairs}
    provider = _rescorer_provider(request)
    rescorer = (
        provider.get_recommend_to_anonymous_rescorer(
            [i for i, _ in pairs], get_rescorer_params(request)
        )
        if provider
        else None
    )
    allowed, rescore = _combine_allowed_rescore(None, rescorer)
    results = await _top_n(
        request, model, vec, how_many, offset, allowed, rescore, context_items
    )
    return render(request, [id_value(i, s) for i, s in results])


async def recommend_with_context(request: web.Request) -> web.Response:
    """GET /recommendWithContext/{userID}/{itemID...}
    (als/RecommendWithContext.java:58)."""
    model = _als_model(request)
    user = request.match_info["userID"]
    pairs = parse_id_value_pairs(split_path_list(request.match_info["items"]))
    how_many, offset = get_how_many_offset(request)
    consider_known = request.query.get("considerKnownItems", "false") == "true"
    uv = check_exists(model.get_user_vector(user), user)
    vec = await _run(request, lambda: model.build_temporary_user_vector(pairs, uv))
    check(vec is not None, "no solver available for model yet", 503)
    known = {i for i, _ in pairs}
    if not consider_known:
        known |= model.get_known_items(user)
    provider = _rescorer_provider(request)
    rescorer = (
        provider.get_recommend_rescorer([user], get_rescorer_params(request))
        if provider
        else None
    )
    allowed, rescore = _combine_allowed_rescore(None, rescorer)
    results = await _top_n(
        request, model, vec, how_many, offset, allowed, rescore, known
    )
    return render(request, [id_value(i, s) for i, s in results])


# ---------------------------------------------------------------------------
# Similarity / estimation
# ---------------------------------------------------------------------------


async def similarity(request: web.Request) -> web.Response:
    """GET /similarity/{itemID...} — mean cosine top-N (als/Similarity.java:59)."""
    model = _als_model(request)
    items = split_path_list(request.match_info["items"])
    how_many, offset = get_how_many_offset(request)
    vectors = [v for i in items if (v := model.get_item_vector(i)) is not None]
    check(bool(vectors), "no known items", 404)
    exclude = set(items)
    results = await _run(
        request,
        lambda: model.top_n_cosine(
            np.stack(vectors), how_many, offset, lambda i: i not in exclude
        ),
    )
    return render(request, [id_value(i, s) for i, s in results])


async def similarity_to_item(request: web.Request) -> web.Response:
    """GET /similarityToItem/{toItemID}/{itemID...} — pairwise cosines
    (als/SimilarityToItem.java:43)."""
    model = _als_model(request)
    to_item = request.match_info["toItemID"]
    items = split_path_list(request.match_info["items"])
    to_vec = check_exists(model.get_item_vector(to_item), to_item)
    norm_to = float(np.linalg.norm(to_vec))
    vecs = []
    for i in items:
        v = model.get_item_vector(i)
        check_exists(v, i)
        vecs.append(v)
    # the device product must not run on the event loop; one executor hop
    # covers the whole pair list, and the cosines are batched into ONE
    # device call + one transfer
    sims = await _run(
        request,
        lambda: vm.cosine_similarities(np.stack(vecs), to_vec, norm_to,
                                       device=model.device).tolist(),
    )
    return render(request, [id_value(i, s) for i, s in zip(items, sims)])


async def estimate(request: web.Request) -> web.Response:
    """GET /estimate/{userID}/{itemID...} — dot products (als/Estimate.java:50)."""
    model = _als_model(request)
    user = request.match_info["userID"]
    items = split_path_list(request.match_info["items"])
    uv = check_exists(model.get_user_vector(user), user)
    dots = model.dot_with_items(uv, items)
    return render(request, [id_value(i, d) for i, d in zip(items, dots)])


async def estimate_for_anonymous(request: web.Request) -> web.Response:
    """GET /estimateForAnonymous/{toItemID}/{itemID=value...}
    (als/EstimateForAnonymous.java:47)."""
    model = _als_model(request)
    to_item = request.match_info["toItemID"]
    pairs = parse_id_value_pairs(split_path_list(request.match_info["items"]))
    to_vec = check_exists(model.get_item_vector(to_item), to_item)
    vec = await _run(request, lambda: model.build_temporary_user_vector(pairs))
    check(vec is not None, "no solver available for model yet", 503)
    return render(request, float(np.dot(vec, to_vec)))


async def because(request: web.Request) -> web.Response:
    """GET /because/{userID}/{itemID} — known items most similar to the item
    (als/Because.java:51)."""
    model = _als_model(request)
    user = request.match_info["userID"]
    item = request.match_info["itemID"]
    how_many, offset = get_how_many_offset(request)
    item_vec = check_exists(model.get_item_vector(item), item)
    known_vecs = model.get_known_item_vectors_for_user(user)
    if not known_vecs:
        return render(request, [])
    norm = float(np.linalg.norm(item_vec))
    # as in similarity_to_item: off the event loop in one hop, cosines
    # batched into one device call
    sim_vals = await _run(
        request,
        lambda: vm.cosine_similarities(
            np.stack([v for _, v in known_vecs]), item_vec, norm,
            device=model.device,
        ).tolist(),
    )
    sims = list(zip((i for i, _ in known_vecs), sim_vals))
    sims.sort(key=lambda t: -t[1])
    return render(request, [id_value(i, s) for i, s in sims[offset:offset + how_many]])


async def most_surprising(request: web.Request) -> web.Response:
    """GET /mostSurprising/{userID} — known items with lowest estimate
    (als/MostSurprising.java:53)."""
    model = _als_model(request)
    user = request.match_info["userID"]
    how_many, offset = get_how_many_offset(request)
    uv = check_exists(model.get_user_vector(user), user)
    known_vecs = model.get_known_item_vectors_for_user(user)
    if not known_vecs:
        return render(request, [])
    dots = [(i, float(np.dot(uv, v))) for i, v in known_vecs]
    dots.sort(key=lambda t: t[1])  # ascending: most surprising first
    return render(request, [id_value(i, s) for i, s in dots[offset:offset + how_many]])


# ---------------------------------------------------------------------------
# Popularity / inventory
# ---------------------------------------------------------------------------


async def popular_representative_items(request: web.Request) -> web.Response:
    """GET /popularRepresentativeItems — top item per feature dimension
    (als/PopularRepresentativeItems.java:42)."""
    model = _als_model(request)

    def compute():
        items = []
        for f in range(model.features):
            unit = np.zeros(model.features, dtype=np.float32)
            unit[f] = 1.0
            top = model.top_n(unit, 1)
            items.append(top[0][0] if top else None)
        return items

    return render(request, await _run(request, compute))


def _top_counts(counts, how_many, offset, rescorer):
    pairs = list(counts.items())
    if rescorer is not None:
        pairs = [(i, c) for i, c in pairs if not rescorer.is_filtered(i)]
    pairs.sort(key=lambda t: -t[1])
    return [id_count(i, c) for i, c in pairs[offset:offset + how_many]]


async def most_popular_items(request: web.Request) -> web.Response:
    """GET /mostPopularItems (als/MostPopularItems.java:51)."""
    model = _als_model(request)
    how_many, offset = get_how_many_offset(request)
    provider = _rescorer_provider(request)
    rescorer = (
        provider.get_most_popular_items_rescorer(get_rescorer_params(request))
        if provider
        else None
    )
    return render(request, _top_counts(model.item_counts(), how_many, offset, rescorer))


async def most_active_users(request: web.Request) -> web.Response:
    """GET /mostActiveUsers (als/MostActiveUsers.java:46)."""
    model = _als_model(request)
    how_many, offset = get_how_many_offset(request)
    provider = _rescorer_provider(request)
    rescorer = (
        provider.get_most_active_users_rescorer(get_rescorer_params(request))
        if provider
        else None
    )
    return render(request, _top_counts(model.user_counts(), how_many, offset, rescorer))


async def known_items(request: web.Request) -> web.Response:
    """GET /knownItems/{userID} (als/KnownItems.java:34)."""
    model = _als_model(request)
    user = request.match_info["userID"]
    return render(request, sorted(model.get_known_items(user)))


async def all_user_ids(request: web.Request) -> web.Response:
    """GET /user/allIDs (als/AllUserIDs.java:33)."""
    return render(request, _als_model(request).all_user_ids())


async def all_item_ids(request: web.Request) -> web.Response:
    """GET /item/allIDs (als/AllItemIDs.java:33)."""
    return render(request, _als_model(request).all_item_ids())


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------


async def set_preference(request: web.Request) -> web.Response:
    """POST /pref/{userID}/{itemID} with strength body (als/Preference.java:41)."""
    user = request.match_info["userID"]
    item = request.match_info["itemID"]
    body = (await request.text()).strip()
    if body:
        try:
            float(body)
        except ValueError as e:
            raise OryxServingException(400, f"bad strength: {body}") from e
    strength = body if body else "1"
    line = textutils.join_delimited([user, item, strength, int(time.time() * 1000)])
    await rsrc.send_input_async(request, line)
    return web.Response(status=200)


async def delete_preference(request: web.Request) -> web.Response:
    """DELETE /pref/{userID}/{itemID} — empty strength = delete
    (als/Preference.java:69)."""
    user = request.match_info["userID"]
    item = request.match_info["itemID"]
    line = textutils.join_delimited([user, item, "", int(time.time() * 1000)])
    await rsrc.send_input_async(request, line)
    return web.Response(status=200)


async def ingest(request: web.Request) -> web.Response:
    """POST /ingest — bulk CSV, gzip/zip/multipart (als/Ingest.java:60-100)."""
    lines = await rsrc.read_body_lines(request)
    for line in lines:
        tokens = textutils.parse_csv(line)
        check(2 <= len(tokens) <= 4, f"bad line: {line}")
    await rsrc.send_input_many(request, lines)
    return web.Response(status=200)


def register(app: web.Application) -> None:
    r = app.router
    r.add_get("/recommend/{userID}", recommend)
    r.add_get("/recommendToMany/{userIDs:.+}", recommend_to_many)
    r.add_get("/recommendToAnonymous/{items:.+}", recommend_to_anonymous)
    r.add_get("/recommendWithContext/{userID}/{items:.+}", recommend_with_context)
    r.add_get("/similarity/{items:.+}", similarity)
    r.add_get("/similarityToItem/{toItemID}/{items:.+}", similarity_to_item)
    r.add_get("/knownItems/{userID}", known_items)
    r.add_get("/estimate/{userID}/{items:.+}", estimate)
    r.add_get("/estimateForAnonymous/{toItemID}/{items:.+}", estimate_for_anonymous)
    r.add_get("/because/{userID}/{itemID}", because)
    r.add_get("/mostSurprising/{userID}", most_surprising)
    r.add_get("/popularRepresentativeItems", popular_representative_items)
    r.add_get("/mostActiveUsers", most_active_users)
    r.add_get("/mostPopularItems", most_popular_items)
    r.add_get("/user/allIDs", all_user_ids)
    r.add_get("/item/allIDs", all_item_ids)
    r.add_post("/pref/{userID}/{itemID}", set_preference)
    r.add_delete("/pref/{userID}/{itemID}", delete_preference)
    r.add_post("/ingest", ingest)

    from oryx_tpu_torch.serving.console import register_console

    register_console(app, "Oryx ALS serving layer", [
        ("GET", "/recommend/{userID}", "top-N recommendations for a user"),
        ("GET", "/recommendToMany/{userID}/...", "recommendations for several users"),
        ("GET", "/recommendToAnonymous/{itemID=value}/...", "recs from item interactions"),
        ("GET", "/recommendWithContext/{userID}/{itemID}/...", "user recs blended with context items"),
        ("GET", "/similarity/{itemID}/...", "items similar to items"),
        ("GET", "/similarityToItem/{toItemID}/{itemID}/...", "pairwise similarities"),
        ("GET", "/knownItems/{userID}", "items the user interacted with"),
        ("GET", "/estimate/{userID}/{itemID}/...", "estimated strengths"),
        ("GET", "/estimateForAnonymous/{toItemID}/{itemID=value}/...", "fold-in estimate"),
        ("GET", "/because/{userID}/{itemID}", "known items explaining a rec"),
        ("GET", "/mostSurprising/{userID}", "known items with lowest estimate"),
        ("GET", "/popularRepresentativeItems", "one item per hash partition"),
        ("GET", "/mostActiveUsers", "users with most known items"),
        ("GET", "/mostPopularItems", "items known to most users"),
        ("GET", "/user/allIDs", "all user IDs"),
        ("GET", "/item/allIDs", "all item IDs"),
        ("POST", "/pref/{userID}/{itemID}", "write a preference"),
        ("DELETE", "/pref/{userID}/{itemID}", "delete a preference"),
        ("POST", "/ingest", "bulk CSV ingest"),
        ("GET", "/metrics", "Prometheus metrics exposition"),
        ("GET", "/trace", "recent + slowest-per-route request traces"),
        ("GET", "/healthz", "liveness probe"),
        ("GET", "/readyz", "readiness probe (model loaded + update lag)"),
    ])
