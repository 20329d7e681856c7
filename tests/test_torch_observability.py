"""The port's SLO engine, tsdb sampler and lineage tracker, held to the
reference's tests and to the reference itself.

The cases of ``tests/test_slo.py`` and ``tests/test_tsdb.py`` that need no
JAX and no reference HTTP app, and the tracker case and the two ALS
generation-id cases of ``tests/test_lineage.py`` (the latter with their
generation helper restated on the port's ``ALSUpdate``), run here with the
reference tests' own bodies rebound to the port's modules (:func:`_mirror`). ``/readyz``'s alert list
is checked on the port's app. Then one parity case per module: the same
series through both packages give the same burn rates and alerts, the same
samples, trend alerts and history, and the same adoption timeline (times
masked).
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import time
import types

import pytest
import torch

from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
from oryx_tpu.api.serving import AbstractServingModelManager as RefManagerBase
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.common import lineage as ref_lineage
from oryx_tpu.common import metrics as ref_metrics
from oryx_tpu.common import slo as ref_slo
from oryx_tpu.common import tsdb as ref_tsdb
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.api.serving import AbstractServingModelManager
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import lineage
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.common import slo
from oryx_tpu_torch.common import tsdb
from oryx_tpu_torch.models.als.update import ALSUpdate

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)


def _mirror(ref_test: str, swap: dict) -> dict:
    """The namespace of the reference test file ``ref_test`` with its
    module-level functions rebound to globals in which ``swap`` replaces
    the reference's modules by the port's: each test body and helper then
    runs unchanged against the port."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ref_test)
    spec = importlib.util.spec_from_file_location(
        "_reference_" + ref_test[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ns = dict(vars(module))
    ns.update(swap)
    for name, fn in vars(module).items():
        if isinstance(fn, types.FunctionType) and fn.__module__ == module.__name__:
            rebound = types.FunctionType(fn.__code__, ns, name, fn.__defaults__,
                                         fn.__closure__)
            rebound.__dict__.update(fn.__dict__)
            ns[name] = rebound
    return ns


_PORT = {"slo": slo, "tsdb": tsdb, "blackbox": blackbox, "cfg": cfg,
         "metrics_mod": metrics_mod, "lineage": lineage}
_SLO = _mirror("test_slo.py", _PORT)
_TSDB = _mirror("test_tsdb.py", _PORT)
_LINEAGE = _mirror("test_lineage.py", _PORT)

_SLO_CASES = [
    "test_burn_rate_is_error_rate_over_budget",
    "test_short_window_recovers_while_long_window_remembers",
    "test_page_requires_both_fast_windows",
    "test_burst_before_first_scrape_survives_the_second_scrape",
    "test_min_events_guards_quiet_replicas",
    "test_budget_remaining_decreases_and_clamps",
    "test_alert_edges_recorded_in_flight_recorder",
    "test_latency_reader_snaps_threshold_to_bucket_edge",
    "test_availability_reader_excludes_ops_routes_and_cancelled",
    "test_configure_defaults_and_gauges_render",
    "test_configure_latency_objective_and_disable",
    "test_active_alerts_shape",
    "test_sample_history_is_count_bounded_under_fast_probing",
    "test_memoized_evaluation_is_one_pass_per_scrape",
    "test_objective_validation",
    "test_window_labels",
]
_TSDB_CASES = [
    "test_full_resolution_tier_is_bit_accurate_at_every_boundary",
    "test_half_mode_matches_legacy_slo_decimation_exactly",
    "test_horizon_trim_keeps_at_least_one_point",
    "test_points_since_is_strictly_newer",
    "test_cap_wins_even_inside_full_resolution_window",
    "test_crossing_eta_pinned_math",
    "test_crossing_eta_edge_cases",
    "test_trend_rule_fires_on_ramp",
    "test_trend_rule_quiet_on_flat_and_noisy_and_far",
    "test_trend_rule_needs_min_points",
    "test_engine_samples_gauges_rates_and_bucket_delta_p99",
    "test_engine_tolerates_missing_families_and_unknown_signals",
    "test_engine_skips_nan_gauge",
    "test_trend_edges_flip_gauge_and_record_blackbox_events",
    "test_history_and_incident_window_shapes",
    "test_configure_defaults",
    "test_configure_disabled_and_payload_shape",
    "test_configure_queue_rule_inherits_batcher_bound",
    "test_configure_signal_subset_and_per_signal_cap",
    "test_reconfigure_carries_ring_history",
    "test_background_sampler_ticks_and_reset_joins_it",
    "test_history_payload_round_trips_through_module",
    "test_trend_alert_fires_strictly_before_slo_page",
]
for _name in _SLO_CASES:
    globals()[f"{_name}_slo"] = _SLO[_name]
for _name in _TSDB_CASES:
    globals()[f"{_name}_tsdb"] = _TSDB[_name]
test_tracker_adoption_timeline_and_anon_models = _LINEAGE[
    "test_tracker_adoption_timeline_and_anon_models"]


def _run_als_once(config, tmp_path, lines, offsets):
    """``tests/test_lineage.py``'s generation helper on the port's
    ``ALSUpdate`` (the reference's imports its own inside the body)."""
    ctx = types.SimpleNamespace(input_offsets=dict(offsets),
                                input_watermark_ms=int(time.time() * 1000))
    producer = _LINEAGE["_RecordingProducer"]()
    ALSUpdate(config, device="cpu").run_update(
        ctx, int(time.time() * 1000),
        [KeyMessage(None, ln) for ln in lines], [],
        str(tmp_path / "model"), producer,
    )
    model_sends = [s for s in producer.sent if s[0] in ("MODEL", "MODEL-REF")]
    assert len(model_sends) == 1, [s[0] for s in producer.sent]
    return lineage.parse_stamp(model_sends[0][2])


# the reference's two ALS lineage cases, their bodies run with the port's
# generation helper above
_LINEAGE["_run_als_once"] = _run_als_once
test_crash_restart_keeps_generation_id_with_checkpointing = _LINEAGE[
    "test_crash_restart_keeps_generation_id_with_checkpointing"]
test_scratch_generations_mint_fresh_ids_without_checkpointing = _LINEAGE[
    "test_scratch_generations_mint_fresh_ids_without_checkpointing"]


@pytest.fixture(autouse=True)
def _clean():
    """``tests/test_tsdb.py``'s autouse reset, on the port's modules; the
    port's default SLO engine and tsdb sampler come back after each case."""
    blackbox.reset_for_tests()
    tsdb.reset_for_tests()
    yield
    tsdb.reset_for_tests()
    blackbox.reset_for_tests()
    slo.configure(cfg.get_default())


def test_mirrored_cases_run_the_ports_modules():
    """Each mirrored case runs the reference's body on the port's module,
    and every reference case is mirrored but the one that needs the
    reference's HTTP app (its port version follows)."""
    for cases, mod in ((_SLO_CASES, "slo"), (_TSDB_CASES, "tsdb")):
        for name in cases:
            assert globals()[f"{name}_{mod}"].__globals__[mod] is _PORT[mod]
    assert _TSDB["_config"].__globals__["cfg"] is cfg
    assert {n for n in _SLO if n.startswith("test_")} - set(_SLO_CASES) == {
        "test_readyz_body_carries_alert_list"}
    assert {n for n in _TSDB if n.startswith("test_")} == set(_TSDB_CASES)


def test_readyz_body_carries_alert_list():
    """/readyz embeds the active-alert list (informational: alerts never
    flip readiness), on the port's app."""
    from aiohttp.test_utils import TestClient, TestServer

    from oryx_tpu_torch.serving.app import make_app

    class _Model:
        def get_fraction_loaded(self):
            return 1.0

    class _Manager:
        def get_model(self):
            return _Model()

        def get_staged_model(self):
            return None

        def is_read_only(self):
            return True

    app = make_app(cfg.get_default(), _Manager())

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.get("/readyz")
            body = await resp.json()
            assert resp.status == 200
            assert "slo_alerts" in body
            assert isinstance(body["slo_alerts"], list)
            assert body["trend_alerts"] == []
        finally:
            await client.close()

    asyncio.run(run())


# -- parity ------------------------------------------------------------------


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_slo_engines_agree_on_one_series():
    clock = _Clock()
    good_bad = {"good": 0.0, "total": 0.0}

    def read():
        return good_bad["good"], good_bad["total"]

    engines = [mod.SloEngine([mod.Objective("availability", 99.0, 3600.0, read)],
                             clock=clock, min_events=1, min_eval_interval_sec=0.0,
                             fast_threshold=2.0)
               for mod in (ref_slo, slo)]
    # healthy, a burst of errors, then a long recovery
    steps = [(100, 0)] * 5 + [(10, 90)] * 3 + [(1000, 0)] * 120
    for good, bad in steps:
        good_bad["good"] += good
        good_bad["total"] += good + bad
        clock.t += 30.0
        ref_status, port_status = (e.evaluate() for e in engines)
        assert ref_status == port_status
        assert engines[0].active_alerts() == engines[1].active_alerts()
    assert engines[1].active_alerts() == []


def _registry_series(mod):
    reg = mod.MetricsRegistry()
    q = reg.gauge("oryx_coalescer_queue_depth", "test")
    hist = reg.histogram("oryx_serving_request_latency_seconds", "test",
                         ("route",))
    return reg, q, hist


def test_tsdb_engines_agree_on_one_series():
    sides = []
    for mod, metrics in ((ref_tsdb, ref_metrics), (tsdb, metrics_mod)):
        reg, q, hist = _registry_series(metrics)
        rule = mod.TrendRule("queue_depth", "queue_depth", 100.0,
                             horizon_sec=600.0, window_sec=120.0, min_points=3)
        eng = mod.TsdbEngine(registry=reg, signals=("queue_depth", "request_rate",
                                                    "request_p99_ms"),
                             trend_rules=[rule])
        sides.append((eng, q, hist))
    fired = False
    for i, depth in enumerate((5.0, 10.0, 30.0, 50.0, 70.0, 90.0, 20.0)):
        samples = []
        for eng, q, hist in sides:
            q.set(depth)
            for j in range(20 * (i + 1)):
                hist.labels("/recommend/{userID}").observe(0.001 * (1 + j % 7))
            samples.append(eng.sample_once(now=2000.0 + 5.0 * i))
        assert samples[0] == samples[1]
        assert sides[0][0].trend_alerts() == sides[1][0].trend_alerts()
        fired = fired or bool(sides[1][0].trend_alerts())
    assert fired  # the ramp raised the queue-depth alert on the way
    assert sides[0][0].history() == sides[1][0].history()
    assert sides[0][0].history(since=2010.0) == sides[1][0].history(since=2010.0)


def _recorder(base):
    """A serving manager on ``base`` that only records what it applies (the
    tracker calls are the base class's ``consume``)."""

    class _Recorder(base):
        def __init__(self):
            super().__init__(None)
            self.applied = []

        def consume_key_message(self, key, message):
            self.applied.append(key)

        def get_model(self):
            return None

    return _Recorder()


def _masked(snapshot: dict) -> dict:
    """A tracker snapshot with its wall-clock fields masked."""
    def mask(rec):
        if rec is None:
            return None
        return {k: (v is not None) if k.endswith("_at") else v
                for k, v in rec.items() if k != "stamp"}

    return {"live": mask(snapshot["live"]), "staged": mask(snapshot["staged"]),
            "generations": [mask(g) for g in snapshot["generations"]],
            "delta": snapshot["delta"], "watermark_ms": snapshot["watermark_ms"]}


def test_managers_build_the_same_adoption_timeline():
    """One stamped stream (two generations, speed deltas with watermarks, an
    unstamped model) through both packages' manager bases: the same
    adoption timelines, watermarks and live generation."""
    now_ms = int(time.time() * 1000)

    def stamp(gen, wm):
        return json.dumps({"generation": gen, "fingerprint": None,
                           "origin": "scratch", "offsets": {"0": 7},
                           "watermark_ms": wm, "published_ms": now_ms})

    def wm(offset, ms):
        return json.dumps({"offsets": {"0": offset}, "watermark_ms": ms})

    stream = [
        ("MODEL", "m1", {ref_lineage.PROVENANCE_HEADER: stamp("g1", now_ms - 9000),
                         ref_lineage.GENERATION_HEADER: "g1"}),
        ("UP", "u", {ref_lineage.GENERATION_HEADER: "g1"}),
        ("UP", "u", {ref_lineage.WATERMARK_HEADER: wm(9, now_ms - 5000)}),
        ("MODEL", "m2", {ref_lineage.PROVENANCE_HEADER: stamp("g2", now_ms - 4000)}),
        ("UP", "u", {ref_lineage.WATERMARK_HEADER: wm(12, now_ms - 1000)}),
        ("MODEL", "m3", None),
        ("MODEL", "m1", {ref_lineage.PROVENANCE_HEADER: stamp("g1", now_ms - 9000)}),
    ]
    ref_lineage.configure(ref_cfg.get_default())
    lineage.configure(cfg.get_default())
    ref, port = _recorder(RefManagerBase), _recorder(AbstractServingModelManager)
    ref.consume(RefKeyMessage(k, m, h) for k, m, h in stream)
    port.consume(KeyMessage(k, m, h) for k, m, h in stream)
    assert port.applied == ref.applied == [k for k, _, _ in stream]
    ref_tracker, port_tracker = ref_lineage.tracker(), lineage.tracker()
    timeline = _masked(port_tracker.snapshot())
    assert _masked(ref_tracker.snapshot()) == timeline
    assert [g["generation"] for g in timeline["generations"]] == ["g1", "g2", "anon-1"]
    # the replayed g1 refreshed its record; the newest live one stays
    assert port_tracker.live_generation() == ref_tracker.live_generation() == "anon-1"
    assert port_tracker.note_query() == ref_tracker.note_query() == "anon-1"
    assert port_tracker.watermark_ms() == ref_tracker.watermark_ms() == now_ms - 1000
