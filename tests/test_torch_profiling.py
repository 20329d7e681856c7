"""The port's ``common/profiling``: cost accounting, memory telemetry and
the profiler session, held to the reference's tests and to the reference.

Mirrored through :func:`_mirror` (the reference test file's own bodies,
rebound to the port's modules): the registry, window and unregistered-call
cases, the device-perf view of a metrics dump, the session's busy refusal
and overdue reclaim, the four ``StepTracer`` cases, capture directories,
three of the four ``POST /debug/profile`` cases (the port's app), and the
five ``--history`` cases.

Restated for the port:

* the two cases tied to XLA compilation have no torch counterpart
  (torch compiles nothing, so there is no ``cost_analysis()``).
  ``test_aot_compile_registers_hand_computed_einsum_flops`` becomes
  :func:`test_serving_scans_register_hand_computed_analytic_costs` (each
  serving scan's analytic cost, by hand) and
  ``test_register_compiled_rejects_unusable_executables`` becomes
  :func:`test_register_clamps_and_supersedes_and_registers_once_per_shape`;
* the gauge, snapshot and wiring cases, which import JAX for its CPU
  device: the port wires the card's gauges only once CUDA is initialised,
  so on the CPU they are absent, and a stand-in ``torch.cuda`` shows the
  wiring;
* the ``/debug/profile`` happy path reads the capture's Chrome trace;
* the blackbox bundle's sections, with the memory section.

The five ``trace_summary --history`` cases run on the port's tool the
same way (its trajectory table and regression gate, over the reference's
``tests/data/BENCH_hist_*.json`` fixtures).

Then the cross-package checks: the port's half-iteration cost equals the
reference's ``_register_half_cost`` on the same batch, block and dtype;
an ``als_train`` (and a resumed one) records calls × that cost;
``memory_snapshot()`` has the reference's keys; and importing
``common.profiling`` and ``common.tracing`` loads no torch.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from oryx_tpu.common import profiling as ref_profiling
from oryx_tpu.models.als import train as ref_tr
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import checkpoint as ck
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import profiling
from oryx_tpu_torch.common.tracing import StepTracer
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.models.als.serving import ALSServingModel
from oryx_tpu_torch.tools import trace_summary as ts
from test_gramian_kernel import _skewed_batch
from test_torch_observability import _mirror

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_make_server(extra: dict):
    from oryx_tpu_torch.serving.app import make_app
    from tests.test_metrics import _AppServer

    config = cfg.overlay_on(extra, cfg.get_default())
    return _AppServer(make_app(config, _REF["_FakeManager"]()))


_REF = _mirror("test_profiling.py", {
    "profiling": profiling, "cfg": cfg, "metrics_mod": metrics_mod,
    "StepTracer": StepTracer, "ts": ts})
# after _mirror: its rebinding would otherwise replace this helper with the
# reference's, which builds the reference's app
_REF["_make_server"] = _port_make_server

_CASES = [
    "test_record_multiplies_calls_by_registered_cost",
    "test_unregistered_program_counts_calls_but_no_flops",
    "test_rates_window_prunes_and_idle_decays",
    "test_device_perf_rows_render_from_metrics_dump",
    "test_profile_session_busy_refusal_and_owner_checked_stop",
    "test_profile_session_overdue_capture_is_reclaimed",
    "test_steptracer_early_close_finalizes_capture",
    "test_steptracer_denied_capture_retries_once_profiler_frees",
    "test_capture_dirs_unique_and_no_orphan_on_busy",
    "test_two_steptracers_share_the_session_without_raising",
    "test_debug_profile_concurrent_second_request_409",
    "test_debug_profile_validates_seconds",
    "test_debug_profile_auth_parity_with_metrics",
    "test_history_renders_trajectory_and_passes_clean_rounds",
    "test_history_flags_injected_regression_nonzero_exit",
    "test_history_cli_entry_point",
    "test_history_compares_same_backend_only",
    "test_history_bare_batch_record_and_skips_unparseable",
]
for _name in _CASES:
    globals()[_name] = _REF[_name]


def _get(snap: dict, name: str, label: str = "", default=0.0):
    return snap.get(name, {}).get(label, default)


def _session_idle():
    profiling.profile_session().stop()
    assert not profiling.profile_session().busy()


# -- restated: the two compilation-bound cases -------------------------------


def _items(n: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return ([f"i{j}" for j in range(n)],
            rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((4, k)).astype(np.float32))


def test_serving_scans_register_hand_computed_analytic_costs():
    """Replaces ``test_aot_compile_registers_hand_computed_einsum_flops``:
    each batched scan registers 2·B·n·k FLOPs and the bytes of the
    representation it reads (float32 4nk, bfloat16 2nk, int8 nk + 4n; LSH
    adds 4n buckets and the (B, buckets) table), under the reference's
    keys, and records one call."""
    n, k = 300, 8
    ids, y, qs = _items(n, k)
    b = len(qs)
    cases = (
        ({"device_dtype": "float32"}, f"als.top_n_batch/b{b}", 4 * n * k),
        ({"device_dtype": "bfloat16"}, f"als.top_n_batch/b{b}", 2 * n * k),
        ({"device_dtype": "int8"}, f"als.top_n_batch/b{b}+int8", n * k + 4 * n),
    )
    for kw, key, nbytes in cases:
        m = ALSServingModel(k, True, device="cpu", **kw)
        m.bulk_load_items(ids, y)
        before = metrics_mod.default_registry().snapshot()
        m.top_n_batch(qs, 5)
        after = metrics_mod.default_registry().snapshot()
        assert profiling.costs().cost(key) == (2.0 * b * n * k, float(nbytes)), kw
        label = f'program="{key}"'
        assert _get(after, "oryx_device_calls_total", label) - _get(
            before, "oryx_device_calls_total", label) == 1
        assert _get(after, "oryx_device_flops_total", label) - _get(
            before, "oryx_device_flops_total", label) == 2.0 * b * n * k
    # the exclusion-carrying signature is its own key
    m.top_n_batch(qs, 5, excluded=[["i0"]] + [None] * (b - 1))
    assert profiling.costs().known(f"als.top_n_batch/b{b}+excl+int8")
    # LSH: the buckets and the candidate table on top of the rows
    lsh = ALSServingModel(k, True, sample_rate=0.5, device="cpu")
    lsh.bulk_load_items(ids, y)
    lsh.top_n_batch(qs, 5)
    assert profiling.costs().cost(f"als.top_n_batch/b{b}") == (
        2.0 * b * n * k, 4.0 * n * k + 4.0 * n + b * lsh.lsh.num_buckets)
    # the IVF probe and cell scan
    ivf = ALSServingModel(k, True, device_dtype="int8", index_enabled=True,
                          index_cells=4, index_probes=2, device="cpu")
    ivf.bulk_load_items(ids, y)
    ivf.top_n_batch(qs, 5)
    snap = ivf.y_snapshot()
    c, width, p = snap.n_cells, snap.cell_width, snap.probes
    assert profiling.costs().cost(f"als.ivf_probe/b{b}/c{c}/p{p}") == (
        2.0 * b * c * k, 4.0 * c * k)
    assert profiling.costs().cost(f"als.ivf_scan/b{b}/c{c}/p{p}") == (
        2.0 * b * p * width * k, float(min(b * p, c) * width * (k + 8)))


def test_register_clamps_and_supersedes_and_registers_once_per_shape():
    """Replaces ``test_register_compiled_rejects_unusable_executables``:
    negative costs clamp to 0, a re-registration supersedes, zero calls
    record nothing; a serving key registers once per snapshot shape, and a
    snapshot with more rows registers again."""
    reg = profiling.CostRegistry()
    reg.register("x", -5.0, -1.0)
    assert reg.cost("x") == (0.0, 0.0)
    reg.register("x", 10.0, 20.0)
    assert reg.cost("x") == (10.0, 20.0)
    reg.record("x", calls=0)
    assert reg.totals() == (0.0, 0.0)

    k = 4
    ids, y, qs = _items(64, k, seed=1)
    m = ALSServingModel(k, True, device="cpu")
    m.bulk_load_items(ids, y)
    m.top_n_batch(qs, 3)
    key = f"als.top_n_batch/b{len(qs)}"
    snap = m.y_snapshot()
    assert key in snap.cost_keys_attempted
    profiling.costs().register(key, 1.0, 1.0)
    m.top_n_batch(qs, 3)  # attempted at this shape: no second registration
    assert profiling.costs().cost(key) == (1.0, 1.0)
    m.set_item_vector("i0", y[1])  # a point update keeps the row count
    m.top_n_batch(qs, 3)
    assert m.y_snapshot() is not snap
    assert profiling.costs().cost(key) == (1.0, 1.0)
    m.set_item_vector("new", y[2])  # one more row: registered anew
    m.top_n_batch(qs, 3)
    assert profiling.costs().cost(key) == (2.0 * len(qs) * 65 * k, 4.0 * 65 * k)


# -- restated: gauges, snapshot and wiring -----------------------------------


class _StandInCuda:
    """A ``torch.cuda`` with one initialised H100, for the wiring cases."""

    def is_initialized(self):
        return True

    def device_count(self):
        return 1

    def get_device_name(self, index=0):
        return "NVIDIA H100 80GB HBM3"

    def memory_stats(self, index):
        return {"allocated_bytes.all.current": 1234,
                "allocated_bytes.all.peak": 5678}

    def mem_get_info(self, index):
        return (1, 80 * 2**30)


def _stand_in_card(monkeypatch):
    """Route the device half to :class:`_StandInCuda`; the families'
    children, the wiring flags and the peaks come back after the test."""
    monkeypatch.setattr(profiling, "_cuda", lambda: _StandInCuda())
    for family in (profiling._DEV_IN_USE, profiling._DEV_PEAK,
                   profiling._DEV_LIMIT):
        monkeypatch.setattr(family, "_children", dict(family._children))
    for name in ("_torch_wired", "_devices_wired", "_peak_flops_per_s",
                 "_peak_bytes_per_s", "_want_auto_flops", "_want_auto_bytes"):
        monkeypatch.setattr(profiling, name, getattr(profiling, name))
    monkeypatch.setattr(metrics_mod, "set_build_info", lambda *a: None)


def test_mfu_and_memory_gauges_on_the_cpu_and_on_a_stand_in_card(monkeypatch):
    # the process's peaks come back as they were after the test
    for name in ("_peak_flops_per_s", "_peak_bytes_per_s", "_want_auto_flops",
                 "_want_auto_bytes"):
        monkeypatch.setattr(profiling, name, getattr(profiling, name))
    config = cfg.overlay_on({
        "oryx.profiling.peak-tflops": 1.0,
        "oryx.profiling.peak-hbm-gbps": 1.0,
    }, cfg.get_default())
    profiling.configure(config)
    profiling.costs().register("test.mfu_prog", 5.0e11, 5.0e8)
    profiling.costs().record("test.mfu_prog", calls=2)
    text = metrics_mod.default_registry().render()

    def value(name: str) -> float:
        m = re.search(rf"^{name} (\S+)$", text, re.M)
        assert m, f"{name} missing from exposition"
        return float(m.group(1))

    assert value("oryx_device_mfu") > 0.0
    assert value("oryx_device_hbm_bandwidth_fraction") > 0.0
    assert value("oryx_device_flops_per_second") > 0.0
    assert value("oryx_host_rss_bytes") > 0.0
    assert value("oryx_host_peak_rss_bytes") > 0.0
    snap = metrics_mod.default_registry().snapshot()
    assert snap["oryx_device_mfu"][""] > 0.0
    if not torch.cuda.is_initialized():
        # no CUDA context in this process: no card gauges, and configure
        # did not create one
        assert 'oryx_device_memory_bytes_in_use{device="cuda' not in text
        assert not torch.cuda.is_initialized()
    # a card: configure wires it, with the known H100 peaks when none is set
    _stand_in_card(monkeypatch)
    profiling.configure(cfg.get_default())
    assert (profiling.peak_flops_per_s(), profiling.peak_bytes_per_s()) == (
        67e12, 3.35e12)
    text = metrics_mod.default_registry().render()
    assert 'oryx_device_memory_bytes_in_use{device="cuda:0"} 1234' in text
    assert 'oryx_device_memory_peak_bytes{device="cuda:0"} 5678' in text
    assert f'oryx_device_memory_limit_bytes{{device="cuda:0"}} {80 * 2**30}' in text
    profiling.configure(cfg.overlay_on({"oryx.profiling.peak-tflops": 2.0},
                                       cfg.get_default()))
    assert profiling.peak_flops_per_s() == 2e12  # an explicit peak wins


def test_memory_snapshot_keys_equal_the_references(monkeypatch):
    snap = profiling.memory_snapshot()
    ref = ref_profiling.memory_snapshot()
    assert set(snap) == set(ref)
    assert snap["host_rss_bytes"] > 0
    assert snap["host_peak_rss_bytes"] >= snap["host_rss_bytes"] // 2
    assert snap["host_peak_rss_mb"] == snap["host_peak_rss_bytes"] // 2**20
    if not torch.cuda.is_initialized():
        assert snap["devices"] == {}
    _stand_in_card(monkeypatch)
    dev = profiling.memory_snapshot()["devices"]
    assert dev == {"cuda:0": {"bytes_in_use": 1234, "peak_bytes": 5678,
                              "limit_bytes": 80 * 2**30}}
    assert set(dev["cuda:0"]) == set(next(iter(ref["devices"].values())))


def test_layer_order_configure_before_torch_wires_on_first_record():
    """The reference's layer-order case, for torch: ``configure`` runs
    before torch is imported and wires nothing; once the process has a
    CUDA context (a stand-in here), the first ``record`` wires the card's
    gauges. Needs a fresh process: this one has torch loaded."""
    code = (
        "import sys\n"
        "from oryx_tpu_torch.common import config as cfg\n"
        "from oryx_tpu_torch.common import profiling as prof\n"
        "assert 'torch' not in sys.modules\n"
        "prof.configure(cfg.get_default())\n"
        "assert not prof._devices_wired\n"
        "import torch\n"
        "prof.costs().record('t')\n"
        "assert not prof._devices_wired and not torch.cuda.is_initialized()\n"
        "c = torch.cuda\n"
        "c.is_initialized = lambda: True\n"
        "c.device_count = lambda: 1\n"
        "c.get_device_name = lambda i=0: 'NVIDIA H100 PCIe'\n"
        "c.memory_stats = lambda i: {'allocated_bytes.all.current': 7}\n"
        "c.mem_get_info = lambda i: (0, 9)\n"
        "prof.costs().register('t', 10.0, 20.0)\n"
        "prof.costs().record('t')\n"
        "assert prof._devices_wired, 'gauges unwired after record()'\n"
        "assert prof.peak_flops_per_s() == 67e12\n"
        "from oryx_tpu_torch.common import metrics as m\n"
        "text = m.default_registry().render()\n"
        "assert 'oryx_device_memory_bytes_in_use{device=\"cuda:0\"} 7' in text\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_profiling_and_tracing_import_no_torch():
    code = ("import sys\n"
            "import oryx_tpu_torch.common.profiling\n"
            "import oryx_tpu_torch.common.tracing\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_tsdb_samples_the_profiling_signals():
    """The tsdb sampler's MFU, HBM, factor-arena and RSS signals read the
    families this module registers in the process registry (before the
    port had it, the sampler skipped them as missing)."""
    from oryx_tpu_torch.common import tsdb
    from oryx_tpu_torch.models.als.vectors import FeatureVectorStore

    store = FeatureVectorStore()
    store.set_vector("a", np.ones(4, np.float32))
    eng = tsdb.TsdbEngine(registry=metrics_mod.default_registry(),
                          signals=("mfu", "hbm_fraction", "arena_bytes",
                                   "host_rss_bytes"))
    got = eng.sample_once(now=1000.0)
    assert set(got) == {"mfu", "hbm_fraction", "arena_bytes", "host_rss_bytes"}
    assert got["arena_bytes"] >= store.arena_nbytes() > 0
    assert got["host_rss_bytes"] > 0


# -- restated: the session and the endpoint's trace ---------------------------


def test_profile_session_refuses_while_a_foreign_torch_profiler_runs(tmp_path):
    _session_idle()
    session = profiling.profile_session()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(profiling.ProfileBusyError, match="outside"):
            session.start(str(tmp_path / "x"), owner="late", max_seconds=5.0)
    assert not session.busy()
    d = session.start(str(tmp_path / "y"), owner="now", max_seconds=5.0)
    torch.ones(8).sum()
    assert session.stop(owner="now") == d


def test_debug_profile_happy_path_writes_a_readable_chrome_trace(tmp_path):
    import httpx

    _session_idle()
    with _port_make_server({
        "oryx.profiling.profile-dir": str(tmp_path / "captures"),
    }) as base:
        r = httpx.post(f"{base}/debug/profile", params={"seconds": "0.2"},
                       timeout=60)
        assert r.status_code == 200, r.text
        body = r.json()
        assert body["seconds"] == 0.2
        trace_dir = body["trace_dir"]
        assert trace_dir.startswith(str(tmp_path / "captures"))
        (trace,) = [f for f in os.listdir(trace_dir)
                    if f.endswith(".pt.trace.json")]
        with open(os.path.join(trace_dir, trace)) as f:
            assert isinstance(json.load(f)["traceEvents"], list)
        assert "trace_summary" in body["hint"]
        assert "pt.trace.json" in body["hint"]
    assert not profiling.profile_session().busy()


def test_bundle_sections_present_and_degrade_independently():
    """``tests/test_blackbox.py``'s case on the port's bundle, with the
    memory section."""
    config = cfg.overlay_on(
        {"oryx.id": "bundle-test", "oryx.serving.api.password": "hunter2"},
        cfg.get_default(),
    )
    blackbox.configure(config)
    blackbox.record_event("breaker.transition", breaker="b", to="open")
    b = blackbox.bundle("unit")
    assert b["reason"] == "unit"
    assert b["oryx_id"] == "bundle-test"
    assert any(e["kind"] == "breaker.transition" for e in b["events"])
    assert "oryx_blackbox_events_total" in b["metrics"]
    assert b["versions"]["python"]
    assert b["versions"]["oryx_tpu_torch"]
    assert b["config"]["oryx.serving.api.password"] == "*****"
    assert set(b["memory"]) == set(ref_profiling.memory_snapshot())
    assert "memory_error" not in b
    assert "hunter2" not in json.dumps(b)
    blackbox.configure(cfg.get_default())


# -- cross-package -------------------------------------------------------------


def _port_batch(batch):
    return RatingBatch(batch.rows, batch.cols, batch.vals, batch.users,
                       batch.items)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_half_cost_equals_the_references(dtype):
    batch, k = _skewed_batch(7)
    ref_sides = ref_tr.prepare_blocked(batch, k, block=64)
    port_sides = tr.prepare_blocked(_port_batch(batch), k, block=64, device="cpu")
    for half, ref_side, port_side in zip(("user", "item"), ref_sides, port_sides):
        key = f"test.half_cost.{half}.{dtype}"
        ref_tr._register_half_cost(key, ref_side, batch.nnz, k, dtype)
        want = ref_profiling.costs().cost(key)
        assert want is not None and want[0] > 0
        assert tr.half_cost(port_side, batch.nnz, k, dtype) == want


def _half_deltas(before: dict, after: dict) -> dict:
    out = {}
    for half in ("user_half", "item_half"):
        label = f'program="als.train.{half}"'
        out[half] = tuple(_get(after, fam, label) - _get(before, fam, label)
                          for fam in ("oryx_device_calls_total",
                                      "oryx_device_flops_total",
                                      "oryx_device_bytes_total"))
    return out


def test_als_train_records_calls_times_the_half_cost(tmp_path):
    """3 iterations record 3 calls a half at the cost of the packed sides;
    a resume from step 1 records only the 2 halves a side it runs, and a
    resume at the final step records none."""
    batch, k = _skewed_batch(8)
    pb = _port_batch(batch)
    sides = dict(zip(("user_half", "item_half"),
                     tr.prepare_blocked(pb, k, device="cpu")))
    cost = {h: tr.half_cost(s, batch.nnz, k, "float32") for h, s in sides.items()}
    store = ck.CheckpointStore(tmp_path / "ckpt", keep=3)
    y0 = np.random.default_rng(3).standard_normal((len(batch.items), k)).astype(np.float32)

    def run():
        before = metrics_mod.default_registry().snapshot()
        tr.als_train(pb, k, 0.1, 1.0, True, 3, init_y=y0, device="cpu",
                     checkpointer=ck.TrainerCheckpointer(store, "f" * 16, 1))
        return _half_deltas(before, metrics_mod.default_registry().snapshot())

    def check(deltas: dict, calls: int) -> None:
        for half, (n, flops, nbytes) in deltas.items():
            assert n == calls
            assert flops == pytest.approx(calls * cost[half][0], rel=1e-12)
            assert nbytes == pytest.approx(calls * cost[half][1], rel=1e-12)

    check(run(), 3)
    for half in cost:
        assert profiling.costs().cost(f"als.train.{half}") == cost[half]
    for _, step, path in store.entries():
        if step > 1:
            path.unlink()
    check(run(), 2)  # resumed from step 1
    check(run(), 0)  # resumed at the final step


def test_smoke_profiling_phase_at_a_small_size(monkeypatch):
    """``chip_smoke.profiling_phase`` on the CPU with a 20,000-item flagship
    and a stand-in card (``torch.cuda``'s memory readings and the device
    half of ``common/profiling``): the iteration's roofline shares from a
    given profile, the b256 scans' gauges read from the rendered metrics,
    ``POST /debug/profile`` refused (409) under a running torch profiler
    and then captured for real, the memory gauges against ``torch.cuda``,
    the bundle's memory section, and the trains' cost checks recorded so
    far."""
    import chip_smoke as cs
    from oryx_tpu_torch.models.als import serving as als_serving

    cpu = torch.device("cpu")
    monkeypatch.setattr(als_serving, "resolve", lambda device=None: cpu)
    monkeypatch.setattr(cs, "FLAGSHIP_ITEMS", 20_000)
    _stand_in_card(monkeypatch)
    card = _StandInCuda()
    monkeypatch.setattr(torch.cuda, "memory_stats", card.memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", card.mem_get_info)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    profiling.configure(cfg.get_default())
    batch, k = _skewed_batch(9)
    monkeypatch.setattr(cs, "FEATURES", k)
    user_side, item_side = tr.prepare_blocked(_port_batch(batch), k, device="cpu")
    before = metrics_mod.default_registry().snapshot()
    tr.als_train(_port_batch(batch), k, 0.1, 1.0, True, 2, device="cpu")
    monkeypatch.setattr(cs, "TRAIN_COSTS", [])
    cs.check_train_costs(before, 2, "train", batch.nnz, (user_side, item_side))
    layer, port, _, threads = cs.profiling_layer(device="cpu")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            busy = cs.debug_profile_busy(port)
        profile = {"wall_ms": 40.0, "device_busy_ms": 20.0}
        flagship, _, _ = cs.flagship_model(np.random.default_rng(4))
        out = cs.profiling_phase(port, busy, {"als_iteration": profile}, user_side,
                                 item_side, batch.nnz, flagship,
                                 np.random.default_rng(5))
    finally:
        closed = cs.close_layer(layer, port, "profiling", threads)
    assert closed["threads_left"] == []
    assert out["debug_profile_during_session"]["status"] == 409
    assert out["debug_profile"]["status"] == 200 and out["debug_profile"]["trace"]["events"]
    assert out["trains"][0]["train"] == "train" and out["trains"][0]["calls"] == 2
    it = out["iteration"]
    assert it["mfu_busy"] == pytest.approx(2 * it["mfu_wall"])
    for scan in ("scan_f32", "scan_int8"):
        assert 0 < out[scan]["mfu_gauge"] <= 1 and out[scan]["calls"] > 0
    assert out["scan_f32"]["flops_per_call"] == 2.0 * 256 * 20_000 * k
    assert out["memory_gauges"]["bytes_in_use"] == 1234
    assert out["bundle_memory"]["devices"]["cuda:0"]["peak_bytes"] == 5678
