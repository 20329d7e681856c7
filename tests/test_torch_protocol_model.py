"""The port's protocol model checker, held to the reference's tests.

* Mirrored cases: every case of ``tests/test_protocol_model.py`` runs with
  the reference test file's own body against the port's explorer, models,
  drift checker and CLI (:func:`_mirror` of
  ``tests/test_torch_static_analysis.py``: the file's globals rebound to
  the port's names, its ``oryx_tpu`` imports answered by
  ``oryx_tpu_torch``). The committed fixtures under
  ``tests/data/protocol_schedules/`` replay on the port's models.
* Restated: the six drift cases and ``test_drift_clean_at_head`` carry the
  reference's transport paths (``"oryx_tpu/transport/x.py"``) in their
  bodies; they are restated below on the port's
  (``"oryx_tpu_torch/transport/x.py"``), where the port's drift checker
  scans.
* Live parity: the port's and the reference's explorers reach the same
  states and transitions and the same minimised counterexample for every
  model and variant (``consumer-group`` at HEAD at depth 8, so the tier-1
  depth is explored once in this file, by the mirrored case), and every
  model site resolves in the port's sources with the reference's
  ``qual`` and ``contains``.
"""

from __future__ import annotations

import os

import pytest

from oryx_tpu.tools.analyze import protocol as ref_proto
from oryx_tpu_torch.tools.analyze import analyze_source
from oryx_tpu_torch.tools.analyze import protocol as proto
from oryx_tpu_torch.tools.analyze.checkers.protocolmodel import (
    ProtocolModelDriftChecker,
    _site_catalog,
)
from oryx_tpu_torch.tools.analyze.cli import main as cli_main
from oryx_tpu_torch.tools.analyze.core import build_project
from oryx_tpu_torch.tools.analyze.protocol import machine
from oryx_tpu_torch.tools.analyze.protocol.machine import Site

from test_torch_static_analysis import REPO_ROOT, _mirror, _port_import

_REF = _mirror("test_protocol_model.py", {
    "proto": proto,
    "Action": machine.Action,
    "Model": machine.Model,
    "S": machine.S,
    "explore": machine.explore,
    "render_schedule": machine.render_schedule,
    "replay": machine.replay,
    "shortest_counterexample": machine.shortest_counterexample,
    "tuple_set": machine.tuple_set,
    "analyze_source": analyze_source,
    "build_project": build_project,
    "ProtocolModelDriftChecker": ProtocolModelDriftChecker,
    "Site": Site,
    "cli_main": cli_main,
    "REPO_ROOT": REPO_ROOT,
})

#: Every case of the reference file that runs on the port unchanged.
MIRRORED = [
    "test_state_record_is_immutable_and_structural",
    "test_tuple_set",
    "test_explore_clean_model_visits_every_state",
    "test_explore_finds_and_minimizes_violation",
    "test_crash_budget_bounds_crash_actions",
    "test_liveness_fires_when_progress_cannot_drain",
    "test_replay_statuses",
    "test_shortest_counterexample_is_minimal",
    "test_canonicalize_collapses_symmetric_states",
    "test_registry_surface",
    "test_head_model_explores_clean_fast",
    "test_head_consumer_group_explores_clean_to_tier1_depth",
    "test_explorer_rediscovers_historical_bug",
    "test_fixtures_cover_all_historical_bugs",
    "test_schedule_fixture_replays",
    "test_cli_protocol_explores_fast_model",
    "test_cli_protocol_variant_prints_counterexample",
    "test_cli_protocol_json",
    "test_cli_protocol_schedule_replay",
    "test_cli_protocol_flag_guards",
]

#: The reference cases restated below on the port's transport paths.
RESTATED = {
    "test_drift_clean_when_annotation_and_coverage_match",
    "test_drift_flags_missing_function",
    "test_drift_flags_line_outside_function",
    "test_drift_flags_missing_fragment",
    "test_drift_flags_unmodelled_guard_relevant_function",
    "test_drift_skips_out_of_scope_files",
    "test_drift_clean_at_head",
}

for _name in MIRRORED:
    globals()[_name] = _REF[_name]


def test_every_reference_case_is_mirrored_or_accounted_for():
    ref_cases = {n for n in _REF if n.startswith("test_")}
    assert set(MIRRORED) | RESTATED == ref_cases
    assert not set(MIRRORED) & RESTATED
    assert len(ref_cases) == 27  # 35 cases with the parametrised ones
    for name in MIRRORED:
        fn = globals()[name]
        assert fn.__globals__["proto"] is proto
        assert fn.__globals__["explore"] is machine.explore
        assert fn.__globals__["__builtins__"]["__import__"] is _port_import


# ---------------------------------------------------------------------------
# the drift cases, restated on the port's transport paths
# ---------------------------------------------------------------------------

_X = "oryx_tpu_torch/transport/x.py"

_MODEL_SRC = '''
SITES = {
    "append": Site("oryx_tpu_torch/transport/x.py", "Broker.append", 3),
}
'''

_IMPL_OK = '''
class Broker:
    def append(self, rec):
        self.log.append(rec)
        return len(self.log)

    def set_offset(self, group, part, off):
        self.offsets[(group, part)] = off
'''


def _drift(catalog, extra):
    """Run only protocol-model-drift over fixture sources with an
    injected site catalog; the fixture transport lives under the port's
    transport prefix so direction 2 scans it."""
    old_cat = ProtocolModelDriftChecker._catalog_override
    ProtocolModelDriftChecker._catalog_override = catalog
    try:
        findings = analyze_source(
            "# anchor module\n" + _MODEL_SRC,
            filename="model_fixture.py",
            checkers=["protocol-model-drift"],
            extra_sources=extra,
        )
    finally:
        ProtocolModelDriftChecker._catalog_override = old_cat
    return [f for f in findings if f.checker == "protocol-model-drift"]


def test_drift_clean_when_annotation_and_coverage_match():
    catalog = [
        ("model_fixture.py", "append", Site(_X, "Broker.append", 3)),
        ("model_fixture.py", "commit", Site(_X, "Broker.set_offset", 7)),
    ]
    assert _drift(catalog, {_X: _IMPL_OK}) == []


def test_drift_flags_missing_function():
    catalog = [
        ("model_fixture.py", "append", Site(_X, "Broker.gone", 3)),
        ("model_fixture.py", "commit", Site(_X, "Broker.set_offset", 7)),
    ]
    out = _drift(catalog, {_X: _IMPL_OK})
    assert any("no such function" in f.message for f in out)


def test_drift_flags_line_outside_function():
    catalog = [
        ("model_fixture.py", "append", Site(_X, "Broker.append", 99)),
        ("model_fixture.py", "commit", Site(_X, "Broker.set_offset", 7)),
    ]
    out = _drift(catalog, {_X: _IMPL_OK})
    assert any("re-anchor" in f.message for f in out)


def test_drift_flags_missing_fragment():
    catalog = [
        ("model_fixture.py", "append",
         Site(_X, "Broker.append", 3, contains="token dedup")),
        ("model_fixture.py", "commit", Site(_X, "Broker.set_offset", 7)),
    ]
    out = _drift(catalog, {_X: _IMPL_OK})
    assert any("fragment is gone" in f.message for f in out)


def test_drift_flags_unmodelled_guard_relevant_function():
    # set_offset exists in the fixture transport but no catalog site
    # covers it -> direction 2 fires on the uncovered function
    catalog = [("model_fixture.py", "append", Site(_X, "Broker.append", 3))]
    out = _drift(catalog, {_X: _IMPL_OK})
    flagged = [f for f in out if "guard-relevant" in f.message]
    assert flagged and flagged[0].symbol == "Broker.set_offset"
    # the reference's transport prefix is not the port's: no coverage scan
    assert _drift(catalog, {"oryx_tpu/transport/x.py": _IMPL_OK}) == []


def test_drift_skips_out_of_scope_files():
    # annotations into files not in the project are not findings
    catalog = [
        ("model_fixture.py", "append",
         Site("oryx_tpu_torch/transport/not_parsed.py", "Broker.append", 3)),
    ]
    assert _drift(catalog, {}) == []


def test_drift_clean_at_head():
    """The port's models' annotations resolve against the port's
    transport/runtime files, and every guard-relevant function of the
    port's transport is covered: zero findings over exactly the files the
    catalog names plus the whole transport package."""
    catalog = _site_catalog()
    assert len(catalog) == 41
    targets = {site.path for _, _, site in catalog}
    assert all(t.startswith("oryx_tpu_torch/") for t in targets)
    paths = [os.path.join(REPO_ROOT, rel) for rel in sorted(targets)]
    paths.append(os.path.join(REPO_ROOT, "oryx_tpu_torch", "transport"))
    project, errors = build_project(paths, REPO_ROOT)
    assert not errors
    out = ProtocolModelDriftChecker().check(project)
    assert out == [], [f.render() for f in out]


# ---------------------------------------------------------------------------
# live parity with the reference's explorer and models
# ---------------------------------------------------------------------------

_PARITY = [(name, variant)
           for name in ref_proto.MODELS
           for variant in ("",) + tuple(ref_proto.MODEL_VARIANTS[name])]


def test_registry_equals_the_reference():
    assert proto.MODELS == ref_proto.MODELS
    assert proto.MODEL_VARIANTS == ref_proto.MODEL_VARIANTS
    assert proto.HISTORICAL_BUGS == ref_proto.HISTORICAL_BUGS
    assert (proto.TIER1_DEPTH, proto.TIER1_CRASH_BUDGET) == (
        ref_proto.TIER1_DEPTH, ref_proto.TIER1_CRASH_BUDGET)


@pytest.mark.parametrize("name,variant", _PARITY)
def test_explorer_parity_with_the_reference(name, variant):
    """Same states, transitions, outcome and minimised counterexample
    schedule as the reference's explorer on the reference's model."""
    depth = 8 if (name == "consumer-group" and not variant) else proto.TIER1_DEPTH
    got = proto.explore(proto.build_model(name, variant), depth=depth,
                        crash_budget=proto.TIER1_CRASH_BUDGET)
    want = ref_proto.explore(ref_proto.build_model(name, variant), depth=depth,
                             crash_budget=ref_proto.TIER1_CRASH_BUDGET)
    assert (got.states, got.transitions, got.ok, got.complete) == (
        want.states, want.transitions, want.ok, want.complete)
    if want.violation is None:
        assert got.violation is None
    else:
        assert got.violation.invariant == want.violation.invariant
        assert list(got.violation.schedule) == list(want.violation.schedule)
        assert got.violation.minimized == want.violation.minimized


@pytest.mark.parametrize("name", list(ref_proto.MODELS))
def test_sites_are_the_references_on_the_ports_sources(name):
    """Each site keeps the reference's key, ``qual`` and ``contains``; its
    path is the port's counterpart of the reference's, and its line lies in
    the named function there (the drift checker's own test, per site)."""
    got = proto.build_model(name).sites()
    want = ref_proto.build_model(name).sites()
    assert len(got) == len(want)
    mod = {"consumer-group": "group_model", "broker-append": "broker_model",
           "ckpt-generation": "ckpt_model"}[name]
    port_sites = getattr(getattr(proto, mod), "SITES")
    ref_sites = getattr(getattr(ref_proto, mod), "SITES")
    assert set(port_sites) == set(ref_sites)
    for key, site in port_sites.items():
        ref = ref_sites[key]
        assert site.path == "oryx_tpu_torch/" + ref.path[len("oryx_tpu/"):]
        assert (site.qual, site.contains) == (ref.qual, ref.contains)
