"""The metric catalog gate of ``tests/test_metric_catalog.py`` over the port.

Every ``oryx_*`` metric the port registers (a literal first argument of a
``counter`` / ``gauge`` / ``histogram`` call anywhere under
``oryx_tpu_torch/``) must be in ``docs/observability.md``, and every name
the reference registers must be registered by the port too, except the
compile half, which the port does not have (:data:`NOT_PORTED`). The last
case is the repair this gate found: the three serving series the port had
dropped (``oryx_serving_topn_batch_seconds``,
``oryx_serving_topn_queries_total``, ``oryx_serving_model_load_fraction``)
render from both packages' registries after the same ``top_n_batch`` on
managers loaded from the same messages.
"""

from __future__ import annotations

import ast
import json
import os
import re

import numpy as np
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import metrics as ref_metrics
from oryx_tpu.models.als.serving import ALSServingModelManager as RefManager
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import metrics
from oryx_tpu_torch.models.als import pmml_codec
from oryx_tpu_torch.models.als.serving import ALSServingModelManager
from oryx_tpu_torch.pmml import pmmlutils

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(REPO, "docs", "observability.md")

#: Reference metrics the port does not register, with the reason: the
#: reference's compile half (the persistent XLA compilation cache and the
#: jit-compile listener) has no counterpart in torch, which compiles no
#: XLA programs; the port's kernels are built by nvcc ahead of use.
NOT_PORTED = {
    "oryx_compile_cache_hits_total": "XLA compilation cache (compile half)",
    "oryx_compile_cache_saved_seconds_total": "XLA compilation cache (compile half)",
    "oryx_jit_compiles_total": "jax.monitoring compile listener (compile half)",
}

#: Names the docs mention that no registry registers (the reference gate's
#: list, plus the port's package name, which shares the prefix).
DOC_ONLY_ALLOWED = {"oryx_fleet_replica_up", "oryx_tpu", "oryx_tpu_torch"}

_NAME_RE = re.compile(r"\boryx_[a-z0-9_]+")


def _registered_names(package: str) -> dict:
    """{metric name: (relpath, kind)} for every literal registration."""
    out: dict = {}
    for root, dirs, files in os.walk(os.path.join(REPO, package)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("counter", "gauge", "histogram")
                    and node.args
                ):
                    continue
                arg = node.args[0]
                if (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith("oryx_")
                ):
                    out[arg.value] = (os.path.relpath(path, REPO), node.func.attr)
    return out


def _doc_names() -> set:
    with open(DOC, encoding="utf-8") as fh:
        return set(_NAME_RE.findall(fh.read()))


def test_every_registered_port_metric_is_cataloged():
    registered = _registered_names("oryx_tpu_torch")
    assert len(registered) >= 80, "AST scan found too few registrations"
    missing = {n: w for n, w in registered.items() if n not in _doc_names()}
    assert not missing, (
        "metric(s) the port registers but docs/observability.md lacks:\n"
        + "\n".join(f"  {n}  ({p}, {k})" for n, (p, k) in sorted(missing.items())))


def test_every_reference_metric_is_registered_by_the_port():
    ref = _registered_names("oryx_tpu")
    port = _registered_names("oryx_tpu_torch")
    missing = sorted(set(ref) - set(port) - set(NOT_PORTED))
    assert not missing, f"reference metrics the port does not register: {missing}"
    # the compile half really is absent, and really is the reference's
    assert set(NOT_PORTED) <= set(ref) and not set(NOT_PORTED) & set(port)
    # same kind for every shared name
    kinds = {n: (ref[n][1], port[n][1]) for n in set(ref) & set(port)
             if ref[n][1] != port[n][1]}
    assert not kinds, kinds


def test_every_cataloged_metric_exists_in_the_port_or_the_compile_half():
    registered = _registered_names("oryx_tpu_torch")
    allowed = set(registered) | DOC_ONLY_ALLOWED | set(NOT_PORTED)
    for name, (_path, kind) in registered.items():
        if kind == "histogram":
            allowed |= {f"{name}_bucket", f"{name}_sum", f"{name}_count"}
    stale = sorted(_doc_names() - allowed)
    assert not stale, f"docs/observability.md names unknown metric(s): {stale}"


_SERIES = ("oryx_serving_topn_batch_seconds_count",
           "oryx_serving_topn_batch_seconds_sum",
           "oryx_serving_topn_queries_total",
           "oryx_serving_model_load_fraction")


def _samples(text: str) -> dict:
    """Unlabelled sample lines of a rendered exposition: name -> value."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or "{" in line.split(" ", 1)[0]:
            continue
        name, _, value = line.partition(" ")
        if name in _SERIES:
            out[name] = float(value.split(" ")[0])
    return out


def _messages(tmp_path, n_users=12, n_items=20, k=4):
    rng = np.random.default_rng(7)
    users = [f"u{i}" for i in range(n_users)]
    items = [f"i{i}" for i in range(n_items)]
    x = rng.standard_normal((n_users, k)).astype(np.float32)
    y = rng.standard_normal((n_items, k)).astype(np.float32)
    pmml = pmml_codec.model_to_pmml(x, y, users, items, k, 0.1, 1.0, True,
                                    False, 1e-5, tmp_path / "model")
    msgs = [("MODEL", pmmlutils.to_string(pmml))]
    msgs += [("UP", json.dumps(["Y", i, y[j].tolist()])) for j, i in enumerate(items)]
    msgs += [("UP", json.dumps(["X", u, x[j].tolist()])) for j, u in enumerate(users)]
    return msgs, x


def test_topn_and_load_fraction_series_render_as_the_reference(tmp_path):
    msgs, x = _messages(tmp_path)
    mgr = ALSServingModelManager(cfg.get_default(), device="cpu")
    ref_mgr = RefManager(ref_cfg.get_default())
    for key, message in msgs:
        mgr.consume([KeyMessage(key, message)])
        ref_mgr.consume([RefKeyMessage(key, message)])
    before = _samples(metrics.default_registry().render())
    ref_before = _samples(ref_metrics.default_registry().render())
    qs = x[:5]
    got = mgr.get_model().top_n_batch(qs, 3)
    want = ref_mgr.get_model().top_n_batch(qs, 3)
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
    after = _samples(metrics.default_registry().render())
    ref_after = _samples(ref_metrics.default_registry().render())
    for series in (after, ref_after):
        assert set(series) == set(_SERIES), sorted(series)
    for b, a in ((before, after), (ref_before, ref_after)):
        # one histogram observe and one counter add of the batch size a call
        assert a["oryx_serving_topn_batch_seconds_count"] - b.get(
            "oryx_serving_topn_batch_seconds_count", 0.0) == 1
        assert a["oryx_serving_topn_queries_total"] - b.get(
            "oryx_serving_topn_queries_total", 0.0) == len(qs)
        assert a["oryx_serving_topn_batch_seconds_sum"] >= b.get(
            "oryx_serving_topn_batch_seconds_sum", 0.0)
    # the gauge reads the newest manager's model at scrape time
    assert after["oryx_serving_model_load_fraction"] == \
        ref_after["oryx_serving_model_load_fraction"] == \
        mgr.get_model().get_fraction_loaded() == 1.0
