"""The port's static analyser, held to the reference's tests.

* Mirrored cases: every case of ``tests/test_static_analysis.py`` whose
  checkers are ported runs with the reference test file's own body against
  the port's analyser (:func:`_mirror`): its globals rebound to the port's
  ``analyze_source`` / ``analyze_project``, and its imports of ``oryx_tpu``
  (module-level or inside a body) answered by ``oryx_tpu_torch``. The
  fixtures' file names and sources name the reference's package layout
  (``oryx_tpu/serving/...``); the port's ``analyze_source`` stand-in
  renames them onto the port's (``oryx_tpu_torch/serving/...``), where the
  port's hot-path prefixes point. Not mirrored: the jit-recompile,
  tracer-leak, compile-on-hot-path and float64-promotion cases (those
  checkers are not ported); the three suppression cases, which seed a
  jit-recompile finding, and the registered-version case, which names
  the unported jit and Pallas checkers, are restated below on ported
  checkers.
* The port's own gates: ``oryx_tpu_torch/`` at zero unsuppressed findings
  against ``conf/analyze-baseline-torch.json``, every suppression
  justified, every port checker with a registered version, the CLI's
  ``--cost`` / ``--protocol`` modes and the reference's guards on their
  flags.
* The host-device-transfer cases of ``tests/test_dataflow_analysis.py`` in
  their torch form, and the torch recogniser's own cases (fetches, casts,
  uploads, waits, the exempt ``device.to_host``). The reference's
  wall-clock gate is not mirrored: the smoke's ``analyze`` line prints the
  analyser's seconds on the card's host instead.
* SARIF and baseline versioning, restated on a ported checker.
"""

from __future__ import annotations

import builtins
import importlib.util
import json
import os
import re
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import oryx_tpu_torch
from oryx_tpu_torch.common.device import to_host
from oryx_tpu_torch.tools.analyze import analyze_project, analyze_source
from oryx_tpu_torch.tools.analyze import dataflow
from oryx_tpu_torch.tools.analyze.core import FileContext, write_baseline

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(oryx_tpu_torch.__file__)))
BASELINE = os.path.join(REPO_ROOT, "conf", "analyze-baseline-torch.json")

_REF_NAME = re.compile(r"\boryx_tpu(?=[./])")


def _to_port(text: str) -> str:
    """A reference fixture's package name (``oryx_tpu.x`` / ``oryx_tpu/x``)
    as the port's."""
    return _REF_NAME.sub("oryx_tpu_torch", text)


def _port_analyze_source(source, filename="fixture.py", checkers=None,
                         reference_conf_text=None, extra_sources=None):
    return analyze_source(
        _to_port(source), _to_port(filename), checkers, reference_conf_text,
        {_to_port(k): _to_port(v) for k, v in (extra_sources or {}).items()})


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == "oryx_tpu" or name.startswith("oryx_tpu.")):
        name = "oryx_tpu_torch" + name[len("oryx_tpu"):]
    return builtins.__import__(name, globals, locals, fromlist, level)


def _mirror(ref_test: str, swap: dict) -> dict:
    """The namespace of the reference test file ``ref_test`` with its
    module-level functions rebound to globals in which ``swap`` replaces
    the reference's names by the port's and every ``oryx_tpu`` import
    executed by a body imports ``oryx_tpu_torch`` instead: each test body
    and helper then runs unchanged against the port."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ref_test)
    spec = importlib.util.spec_from_file_location(
        "_reference_" + ref_test[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ns = dict(vars(module))
    ns.update(swap)
    port_builtins = dict(vars(builtins))
    port_builtins["__import__"] = _port_import
    ns["__builtins__"] = port_builtins
    for name, fn in vars(module).items():
        if isinstance(fn, types.FunctionType) and fn.__module__ == module.__name__:
            rebound = types.FunctionType(fn.__code__, ns, name, fn.__defaults__,
                                         fn.__closure__)
            rebound.__kwdefaults__ = fn.__kwdefaults__
            rebound.__dict__.update(fn.__dict__)
            ns[name] = rebound
    return ns


_REF = _mirror("test_static_analysis.py", {
    "analyze_source": _port_analyze_source,
    "analyze_project": analyze_project,
    "oryx_tpu": oryx_tpu_torch,
    "REPO_ROOT": REPO_ROOT,
    "BASELINE": BASELINE,
})

#: Every case of the reference file that runs on the port, by its name.
MIRRORED = [
    "test_blocking_async_fires_on_sleep_and_lock",
    "test_blocking_async_quiet_on_async_sleep_and_executor",
    "test_blocking_async_propagates_through_project_calls",
    "test_blocking_async_fires_on_sync_socket_io_in_server_handler",
    "test_blocking_async_quiet_on_netbroker_server_shape",
    "test_profile_endpoint_shape_passes_both_hot_path_checkers",
    "test_blocking_async_fires_when_capture_skips_the_thread_hop",
    "test_lock_discipline_fires_on_unguarded_read",
    "test_lock_discipline_quiet_when_every_access_guarded",
    "test_config_drift_fires_on_unknown_and_unread_keys",
    "test_config_drift_quiet_when_keys_match",
    "test_config_drift_resolves_fstrings_and_get_config_prefixes",
    "test_log_discipline_fires_on_print_and_bare_getlogger_in_hot_paths",
    "test_log_discipline_quiet_outside_hot_paths_and_on_adapter",
    "test_swallowed_exception_fires_on_silent_broad_catches",
    "test_swallowed_exception_quiet_on_narrow_logged_or_reraised",
    "test_swallowed_exception_fires_on_silent_async_server_catch",
    "test_swallowed_exception_quiet_on_netbroker_dispatch_shape",
    "test_per_row_store_fires_on_dict_of_ndarray_accumulation",
    "test_per_row_store_quiet_on_arena_idiom_and_cold_paths",
    "test_lock_order_cycle_fires_on_inverted_nesting",
    "test_lock_order_cycle_fires_interprocedurally",
    "test_lock_order_cycle_quiet_on_consistent_order_and_reentry",
    "test_blocking_under_lock_fires_on_sleep_await_and_executor",
    "test_blocking_under_lock_quiet_when_work_moves_outside",
    "test_blocking_under_lock_quiet_after_try_finally_release",
    "test_lock_order_cycle_quiet_on_async_callee_acquisitions",
    "test_shared_state_escape_quiet_with_common_module_lock",
    "test_blocking_under_lock_catches_pr9_tombstone_spin_shape",
    "test_blocking_under_lock_quiet_on_generator_loops",
    "test_cli_changed_rejects_update_baseline_and_emits_json",
    "test_shared_state_escape_fires_on_cross_context_writes",
    "test_shared_state_escape_fires_on_thread_subclass_run",
    "test_shared_state_escape_quiet_with_common_lock_or_one_context",
    "test_call_graph_is_built_once_and_shared",
    "test_attr_typed_call_edges_resolve_helper_classes",
    "test_analyze_changed_scopes_report_but_keeps_cross_file_reachability",
    "test_package_has_no_unsuppressed_findings",
    "test_metrics_keys_are_declared_and_read",
    "test_cli_analyze_json_exit_zero",
]

#: Reference cases of checkers the port does not have (no JAX tracing, no
#: Pallas sources), and the cases restated below.
NOT_MIRRORED = {
    "test_jit_recompile_fires_on_traced_branch",
    "test_jit_recompile_quiet_on_static_and_shape_branches",
    "test_jit_recompile_fires_on_jit_in_loop_and_fstring",
    "test_jit_recompile_quiet_on_lru_cached_builder",
    "test_jit_recompile_fires_on_typoed_static_argname",
    "test_tracer_leak_fires_on_concretization_in_jit",
    "test_tracer_leak_quiet_outside_jit_and_on_static",
    "test_hot_compile_fires_on_jit_in_handler",
    "test_hot_compile_propagates_through_lower_helper",
    "test_hot_compile_quiet_on_warmup_route_and_str_lower",
    "test_float64_fires_inside_jit",
    "test_float64_quiet_on_f32_and_host_code",
    # restated on lock-discipline / the port's registry below
    "test_inline_suppression_needs_justification",
    "test_inline_suppression_with_justification_is_clean",
    "test_stale_suppression_is_flagged",
    "test_every_checker_has_a_registered_version",
}

for _name in MIRRORED:
    globals()[_name] = _REF[_name]


@pytest.fixture(scope="module")
def project_analysis():
    """One analyze_project sweep of the port's package, shared by the
    mirrored gate cases."""
    return analyze_project(
        [os.path.join(REPO_ROOT, "oryx_tpu_torch")],
        root=REPO_ROOT,
        baseline_path=BASELINE,
    )


def _run(src: str, checker: str, **kw):
    findings = analyze_source(textwrap.dedent(src), **kw)
    return [f for f in findings if f.checker == checker]


def test_every_reference_case_is_mirrored_or_accounted_for():
    ref_cases = {n for n in _REF if n.startswith("test_")}
    assert set(MIRRORED) | NOT_MIRRORED == ref_cases
    assert not set(MIRRORED) & NOT_MIRRORED
    for name in MIRRORED:
        fn = globals()[name]
        assert fn.__globals__["analyze_source"] is _port_analyze_source
        assert fn.__globals__["__builtins__"]["__import__"] is _port_import


# ---------------------------------------------------------------------------
# the three suppression cases, restated on lock-discipline
# ---------------------------------------------------------------------------

_UNGUARDED = """
    import threading

    class Store:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = {}

        def put(self, k, v):
            with self._lock:
                self.items[k] = v

        def size(self):
            return len(self.items){comment}
"""


def test_inline_suppression_needs_justification():
    src = _UNGUARDED.replace("{comment}", "  # analyze: ignore[lock-discipline]")
    findings = analyze_source(textwrap.dedent(src))
    locks = [f for f in findings if f.checker == "lock-discipline"]
    hygiene = [f for f in findings if f.checker == "suppression-hygiene"]
    assert locks and locks[0].suppressed_by == "inline"
    assert len(hygiene) == 1  # no justification text -> hygiene finding


def test_inline_suppression_with_justification_is_clean():
    src = _UNGUARDED.replace(
        "{comment}",
        "  # analyze: ignore[lock-discipline] -- advisory size; a torn read is fine")
    findings = analyze_source(textwrap.dedent(src))
    assert all(f.suppressed_by == "inline" for f in findings
               if f.checker == "lock-discipline")
    assert not [f for f in findings if f.checker == "suppression-hygiene"]


def test_stale_suppression_is_flagged():
    src = """
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = {}

            def size(self):
                with self._lock:
                    return len(self.items)  # analyze: ignore[lock-discipline] -- fixed long ago
    """
    findings = analyze_source(textwrap.dedent(src))
    stale = [f for f in findings
             if f.checker == "suppression-hygiene" and "stale" in f.message]
    assert len(stale) == 1


def test_every_checker_has_a_registered_version():
    """Every port checker exposes a version, under the reference's ids and
    versions, so a port baseline entry reads like a reference one."""
    from oryx_tpu.tools.analyze.checkers import CHECKER_VERSIONS as REF_VERSIONS
    from oryx_tpu_torch.tools.analyze.checkers import ALL_CHECKERS, CHECKER_VERSIONS

    assert set(CHECKER_VERSIONS) == {c.id for c in ALL_CHECKERS}
    assert all(isinstance(v, int) and v >= 1 for v in CHECKER_VERSIONS.values())
    assert set(CHECKER_VERSIONS) == {
        "blocking-async", "lock-discipline", "lock-order-cycle",
        "blocking-under-lock", "shared-state-escape", "config-key-drift",
        "log-discipline", "swallowed-exception", "per-row-ndarray-store",
        "host-device-transfer", "replicated-collective", "dtype-widening",
        "protocol-model-drift"}
    assert all(REF_VERSIONS[cid] == v for cid, v in CHECKER_VERSIONS.items())


# ---------------------------------------------------------------------------
# the port's own gates
# ---------------------------------------------------------------------------


def test_port_is_at_zero_with_every_suppression_justified(project_analysis):
    result = project_analysis
    assert result.parse_errors == []
    assert result.unsuppressed == [], "\n" + "\n".join(
        f.render() for f in result.unsuppressed)
    assert result.suppressed
    for f in result.suppressed:
        assert f.justification and not f.justification.startswith("TODO"), f.render()
    with open(BASELINE, encoding="utf-8") as fh:
        entries = json.load(fh)["entries"]
    assert entries and all(e["justification"] and e["version"] >= 1
                           for e in entries)
    # the reference's baseline is not the port's
    assert all(e["path"].startswith("oryx_tpu_torch/") for e in entries)


def test_analyser_imports_neither_jax_nor_the_reference():
    code = ("import sys, oryx_tpu_torch.tools.analyze.cli as c; "
            "rc = c.main(['--format', 'json', '--checker', 'config-key-drift']); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'oryx_tpu', 'torch')); "
            "print(bad, file=sys.stderr); sys.exit(rc or (1 if bad else 0))")
    env = dict(os.environ)
    env.pop("ORYX_SANITIZE", None)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stderr.strip().splitlines()[-1] == "[]"


#: Each flag the port's CLI once refused: its mode working now, or the
#: reference's own guard refusing it out of its mode.
_PORTED_MODES = {
    "--cost": (["--cost", "--format", "json"], 0, '"programs"'),
    "--bind=k=50": (["--bind=k=50"], 2, "--bind only applies to --cost"),
    "--protocol": (["--protocol", "--model", "ckpt-generation"], 0,
                   "ckpt-generation  variant=HEAD"),
    "--model=broker-append": (["--model=broker-append"], 2,
                              "--model only applies to --protocol"),
    "--schedule=x.json": (["--schedule=x.json"], 2,
                          "--schedule only applies to --protocol"),
}


@pytest.mark.parametrize("flag", ["--cost", "--bind=k=50", "--protocol",
                                  "--model=broker-append", "--schedule=x.json"])
def test_cli_unported_modes_exit_2_naming_the_roadmap_item(flag, capsys):
    """The modes the port's CLI once answered with exit 2 are ported
    (ROADMAP item 7d): ``--cost`` and ``--protocol`` run, and the flags
    that belong to a mode are refused outside it, as the reference's CLI
    refuses them."""
    from oryx_tpu_torch.tools.analyze import cli

    argv, rc, text = _PORTED_MODES[flag]
    assert cli.main(argv) == rc
    out = capsys.readouterr()
    assert text in (out.out if rc == 0 else out.err)
    assert "not ported yet" not in out.err


def test_cli_sarif_over_the_port_parses(capsys):
    from oryx_tpu_torch.tools.analyze.cli import main

    rc = main(["--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0  # the port is clean: everything suppressed
    assert doc["version"] == "2.1.0"
    results = doc["runs"][0]["results"]
    assert results, "suppressed findings still render"
    assert all("suppressions" in r and r["level"] == "note" for r in results)
    kinds = {r["suppressions"][0]["kind"] for r in results}
    assert kinds == {"inSource", "external"}


# ---------------------------------------------------------------------------
# host-device-transfer: the reference's cases in their torch form
# ---------------------------------------------------------------------------


def test_host_transfer_fires_in_async_handler_and_through_calls():
    hits = _run(
        """
        import asyncio
        import numpy as np
        import torch

        async def handler(request, xs):
            scores = torch.mm(torch.as_tensor(xs, device="cuda"), xs.T)
            return scores.cpu()              # fetch ON the event loop

        def helper(xs):
            s = torch.ones(4, device="cuda").sum()
            return float(s)

        async def handler2(request, xs):
            return helper(xs)                # reachable: helper's sync fires
        """,
        "host-device-transfer",
    )
    assert len(hits) == 2
    assert {f.symbol.split(":")[0] for f in hits} == {"handler", "helper"}
    assert all("event loop" in f.message for f in hits)


def test_host_transfer_quiet_on_to_thread_hop():
    hits = _run(
        """
        import asyncio
        import torch

        def helper(xs):
            s = torch.ones(4, device="cuda").sum()
            return float(s)

        async def handler(request, xs):
            return await asyncio.to_thread(helper, xs)
        """,
        "host-device-transfer",
    )
    assert hits == []


def test_host_transfer_fires_in_training_loop_and_exempts_to_host():
    src = """
        import numpy as np
        import torch

        from oryx_tpu_torch.common.device import to_host

        def grow(levels, dev):
            assign = torch.zeros((8,), device=dev)
            for depth in range(10):
                gain, feat = step(assign)
                g = gain.cpu().numpy()          # silent sync per level
                levels.append(g)
            return levels

        def grow_fixed(levels, dev):
            assign = torch.zeros((8,), device=dev)
            for depth in range(10):
                gain, feat = step(assign)
                g, f = to_host(gain, feat)      # explicit + batched
                levels.append(g)
            return levels

        def step(assign):
            return assign * 2, assign + 1
        """
    hits = _run(src, "host-device-transfer",
                filename="oryx_tpu_torch/models/fake/train.py")
    assert len(hits) == 1
    assert hits[0].symbol.startswith("grow:")
    assert "training-tier loop" in hits[0].message


def test_host_transfer_fires_per_element_sync_and_quiet_when_batched():
    violation = """
        import torch

        def pair_sim(x, y):
            return torch.dot(x.to("cuda"), y.to("cuda"))

        def collect(vecs, q):
            return [float(pair_sim(v, q)) for v in vecs]
    """
    hits = _run(violation, "host-device-transfer",
                filename="oryx_tpu_torch/serving/fixture.py")
    assert len(hits) == 1 and "PER ITEM" in hits[0].message

    batched = """
        import numpy as np
        import torch

        def batch_sims(rows, q):
            return torch.as_tensor(rows, device="cuda") @ torch.as_tensor(q, device="cuda")

        def collect(vecs, q):
            sims = batch_sims(np.stack(vecs), q).cpu().numpy()
            return [float(s) for s in sims]     # host floats: free
    """
    assert _run(batched, "host-device-transfer",
                filename="oryx_tpu_torch/serving/fixture.py") == []


def test_host_transfer_loop_targets_bind_iterated_elements():
    fires = """
        import torch

        def drain(x):
            scores = torch.mm(x.cuda(), x.cuda().T)
            out = []
            for s in scores:
                out.append(s.item())   # one transfer PER ELEMENT
            return out
        """
    hits = _run(fires, "host-device-transfer",
                filename="oryx_tpu_torch/serving/fixture.py")
    assert len(hits) == 1 and ".item()" in hits[0].symbol

    shadowed = """
        import torch

        def shadow(x, hostvals):
            v = torch.mm(x.cuda(), x.cuda().T)
            keep = v
            return [float(v) for v in hostvals]   # comp v is HOST
        """
    assert _run(shadowed, "host-device-transfer",
                filename="oryx_tpu_torch/serving/fixture.py") == []


def test_host_transfer_augassign_keeps_device_state():
    src = """
        import torch

        def train_loop(n, dev):
            loss = torch.zeros((), device=dev)
            out = []
            for i in range(n):
                loss += 1
                out.append(float(loss))   # still a device sync per step
            return out
        """
    hits = _run(src, "host-device-transfer",
                filename="oryx_tpu_torch/models/fake/train.py")
    assert len(hits) == 1 and "float" in hits[0].symbol


def test_host_transfer_quiet_in_loop_else_blocks():
    src = """
        import torch

        def train_once(n, dev):
            y = torch.zeros((4,), device=dev)
            for i in range(n):
                y = y * 2
            else:
                total = y.cpu()       # once, after the loop: quiet
            return total
        """
    assert _run(src, "host-device-transfer",
                filename="oryx_tpu_torch/models/fake/train.py") == []


def test_host_transfer_flow_sensitive_after_host_reassignment():
    src = """
        import torch

        async def handler(request, xs):
            vals = torch.mm(xs.cuda(), xs.cuda().T)
            vals = vals.cpu().numpy()        # the one (flagged) transfer
            return [float(v) for v in vals]  # host reads: quiet
        """
    hits = _run(src, "host-device-transfer")
    assert len(hits) == 1
    assert ".cpu()" in hits[0].symbol


# ---------------------------------------------------------------------------
# host-device-transfer: the torch recogniser's own cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fetch", [
    "acc.item()", "acc.cpu()", "acc.tolist()", "float(acc)", "int(acc)",
    "bool(acc)", "np.asarray(acc)", "acc.to('cpu')", "torch.nonzero(acc)",
    "acc.nonzero()",
])
def test_host_transfer_fires_on_each_fetch_in_a_trainer_loop(fetch):
    src = f"""
        import numpy as np
        import torch

        def fit(n, dev):
            acc = torch.zeros((4,), device=dev)
            for i in range(n):
                acc = acc + 1
                seen = {fetch}
            return acc
        """
    hits = _run(src, "host-device-transfer",
                filename="oryx_tpu_torch/models/fake/train.py")
    assert len(hits) == 1, hits
    assert "training-tier loop" in hits[0].message


def test_host_transfer_quiet_on_casts_uploads_waits_and_host_numpy():
    src = """
        import numpy as np
        import torch

        from oryx_tpu_torch.common import device

        def fit(n, dev, host):
            acc = torch.zeros((4,), device=dev)
            stream = torch.cuda.current_stream(dev)
            for i in range(n):
                acc = acc.float() + acc.half().to(torch.float32)
                acc = acc.to(dtype=torch.float64).to(acc.dtype)
                rows = torch.as_tensor(host, device=dev)   # an upload
                more = torch.from_numpy(host).to(dev)      # an upload
                acc = acc + rows.sum() + more.sum()
                stream.synchronize()                       # explicit wait
                torch.cuda.synchronize(dev)                # explicit wait
                (got,) = device.to_host(acc)               # the exempt fetch
                host = np.asarray(host) * 2                # host numpy
                total = float(np.sum(host))                # host float
            return acc
        """
    assert _run(src, "host-device-transfer",
                filename="oryx_tpu_torch/models/fake/train.py") == []


def test_host_transfer_follows_device_values_through_helpers_and_attributes():
    """The port passes device tensors through parameters and keeps them on
    ``self``: a helper whose result is computed from a device argument
    returns a device value at that call site (``device_if_args``), and an
    attribute a method assigns a device value is device everywhere in the
    class."""
    src = """
        import torch

        def _sweep(points, centers):
            d = torch.cdist(points, centers)
            return d.argmin(dim=1)

        class Model:
            def __init__(self, dev):
                self.mat = torch.zeros((4, 4), device=dev)

            def fit(self, n, host):
                pts = torch.as_tensor(host, device=self.mat.device)
                for i in range(n):
                    assign = _sweep(pts, self.mat)
                    first = assign.tolist()          # device via the helper
                    norm = self.mat.sum().item()     # device via the attribute
                    local = _sweep(host, host)       # host args: host result
                    seen = local.tolist()
                return first, norm, seen
        """
    hits = _run(src, "host-device-transfer",
                filename="oryx_tpu_torch/models/fake/train.py")
    assert sorted(f.symbol for f in hits) == [
        "Model.fit:.item():self.mat.sum()", "Model.fit:.tolist():assign"]
    from oryx_tpu_torch.tools.analyze.core import ProjectContext

    project = ProjectContext([FileContext("m.py", "m.py", textwrap.dedent(src))])
    assert ("m.py", "_sweep") in dataflow.device_if_args(project)
    assert ("m.py", "_sweep") not in dataflow.device_returning(project)


def test_transfer_recogniser_classifies_each_kind():
    src = textwrap.dedent("""
        import numpy as np
        import torch
        from oryx_tpu_torch.common.device import to_host

        def f(t, dev, host, stream):
            a = t.item()
            b = t.cpu()
            c = float(t)
            d = np.asarray(t)
            e = t.to("cpu")
            g = torch.nonzero(t)
            h = t.to(dev)
            i = torch.as_tensor(host, device=dev)
            j = t.cuda()
            k = stream.synchronize()
            m = to_host(t)
            n = t.float()
            o = t.to(torch.bfloat16)
            p = t.to(dev, non_blocking=True)
            q = torch.zeros(3, device=dev)
    """)
    fctx = FileContext("m.py", "m.py", src)
    kinds = {}
    for line in range(7, 22):
        got = dataflow.transfers_at(fctx, line)
        kinds[fctx.lines[line - 1].split("=")[0].strip()] = (
            [k for _, k in got][0] if got else None)
    assert kinds == {
        "a": ".item()", "b": ".cpu()", "c": "float()", "d": "np.asarray()",
        "e": ".to(cpu)", "g": "torch.nonzero()", "h": "upload:.to(device)",
        "i": "upload:torch.as_tensor(device=)", "j": "upload:.cuda()",
        "k": "wait:.synchronize()", "m": "wait:to_host()", "n": None,
        "o": None, "p": None, "q": None,
    }
    assert [dataflow.is_reported_kind(kinds[x]) for x in "abeghkm"] == [
        True, True, True, True, False, False, False]


@pytest.mark.parametrize("shapes", [[(3,)], [(2, 3), (4,)], [(0,), (5, 1)]])
def test_to_host_returns_what_cpu_numpy_returns(shapes):
    rng = np.random.default_rng(len(shapes))
    ts = [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
          for s in shapes] + [torch.arange(4)]
    got = to_host(*ts)
    assert len(got) == len(ts)
    for g, t in zip(got, ts):
        want = t.cpu().numpy()
        assert g.dtype == want.dtype and g.shape == want.shape
        np.testing.assert_array_equal(g, want)


def test_per_row_store_counts_a_dict_of_tensors():
    hits = _run(
        """
        import torch

        class TensorMap:
            def __init__(self):
                self._vectors = {}
                self._rows = {}

            def set_vector(self, id_, vec):
                self._vectors[id_] = torch.as_tensor(vec)   # a tensor per id

            def set_clone(self, id_, vec):
                v = torch.tensor(vec, dtype=torch.float32)
                self._vectors[id_] = v.clone()              # a tensor per id

            def set_row(self, id_, row):
                self._rows[id_] = int(row)                  # an index: fine
        """,
        "per-row-ndarray-store",
        filename="oryx_tpu_torch/models/fixture.py",
    )
    assert sorted(f.symbol for f in hits) == [
        "TensorMap.set_clone:_vectors", "TensorMap.set_vector:_vectors"]


# ---------------------------------------------------------------------------
# SARIF and baseline versioning, restated on a ported checker
# ---------------------------------------------------------------------------

_RACY = textwrap.dedent(_UNGUARDED.replace("{comment}", ""))


def _write_fixture_project(d: str) -> None:
    with open(os.path.join(d, "m.py"), "w", encoding="utf-8") as fh:
        fh.write(_RACY)


def test_sarif_renders_findings_with_suppressions(tmp_path):
    from oryx_tpu_torch.tools.analyze.sarif import to_sarif

    d = str(tmp_path)
    _write_fixture_project(d)
    doc = to_sarif(analyze_project([d], root=d))
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "oryx-analyze"
    assert "lock-discipline" in {r["id"] for r in run["tool"]["driver"]["rules"]}
    res = [r for r in run["results"] if r["ruleId"] == "lock-discipline"]
    assert len(res) == 1
    loc = res[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "m.py"
    assert loc["region"]["startLine"] > 1
    assert res[0]["level"] == "error" and "suppressions" not in res[0]


def test_baseline_version_mismatch_invalidates_loudly(tmp_path):
    d = str(tmp_path)
    _write_fixture_project(d)
    baseline = os.path.join(d, "baseline.json")
    entry = {"checker": "lock-discipline", "path": "m.py",
             "symbol": "Store.items:size", "justification": "accepted",
             "version": 999}
    with open(baseline, "w", encoding="utf-8") as fh:
        json.dump({"entries": [entry]}, fh)
    result = analyze_project([d], root=d, baseline_path=baseline)
    rep = [f for f in result.findings if f.checker == "lock-discipline"]
    assert rep and all(f.suppressed_by is None for f in rep)
    hygiene = [f for f in result.findings
               if f.checker == "suppression-hygiene" and "v999" in f.message]
    assert len(hygiene) == 1 and "now v1" in hygiene[0].message

    entry["version"] = 1
    with open(baseline, "w", encoding="utf-8") as fh:
        json.dump({"entries": [entry]}, fh)
    result = analyze_project([d], root=d, baseline_path=baseline)
    rep = [f for f in result.findings if f.checker == "lock-discipline"]
    assert rep and all(f.suppressed_by == "baseline" for f in rep)
    assert not [f for f in result.findings if f.checker == "suppression-hygiene"]


def test_update_baseline_records_checker_version(tmp_path):
    d = str(tmp_path)
    _write_fixture_project(d)
    result = analyze_project([d], root=d)
    out = os.path.join(d, "baseline.json")
    write_baseline(out, result.findings)
    with open(out, "r", encoding="utf-8") as fh:
        entries = json.load(fh)["entries"]
    assert entries and all(e["version"] == 1 for e in entries)
    assert any(e["checker"] == "lock-discipline" for e in entries)


# ---------------------------------------------------------------------------
# the smoke's analyze phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_smoke_analyze_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.analyze_phase`` at a small size on the CPU: the analyser
    child exits 0 at zero unsuppressed findings; the three windows run with
    the sync mode set and restored; a stand-in for the card's sync report
    (a warning from each fetch method while the mode is ``warn``; on the
    CPU ``to_host`` reads with ``.numpy()``) is charged
    to the innermost port frame, and every such site is one the recogniser
    classifies."""
    import warnings

    import chip_smoke as cs
    from oryx_tpu_torch.models.als import data as als_data
    from oryx_tpu_torch.models.als import train as tr
    from oryx_tpu_torch.models.als.serving import ALSServingModel
    from oryx_tpu_torch.models.kmeans import train as kmtrain

    cpu = torch.device("cpu")
    modes = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(kmtrain, "resolve", lambda device=None: cpu)

    def syncing(name):
        orig = getattr(torch.Tensor, name)

        def method(self, *args, **kwargs):
            if modes and modes[-1] == "warn":
                warnings.warn("called a " + cs.SYNC_WARNING)
            return orig(self, *args, **kwargs)
        return method

    for name in ("cpu", "numpy", "item", "tolist", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, syncing(name))
    for name, value in dict(N_USERS=2_000, N_ITEMS=300, NNZ=8_000, FEATURES=8,
                            KM_K=8, KM_ITERATIONS=2, ANALYZE_KM_N=400,
                            ANALYZE_TOPN_BATCH=4, FLAGSHIP_ITEMS=500).items():
        monkeypatch.setattr(cs, name, value)
    # the protocol child explores only ckpt-generation here (at the tier-1
    # depth, with the reference's counts): consumer-group at depth 12 is
    # explored by tests/test_torch_protocol_model.py and by the smoke itself
    ckpt = {"ckpt-generation": cs.PROTOCOL_COUNTS["ckpt-generation"]}
    monkeypatch.setattr(cs, "PROTOCOL_COUNTS", ckpt)
    child = cs.analyze_child

    def one_model_child(args, timeout):
        if args[0] == "--protocol" and "--schedule" not in args:
            args = [*args, "--model", "ckpt-generation"]
        return child(args, timeout)
    monkeypatch.setattr(cs, "analyze_child", one_model_child)
    rng = np.random.default_rng(cs.SEED)
    batch = als_data.prepare(cs.synthetic_lines(rng), implicit=True)
    user_side, item_side = tr.prepare_blocked(batch, 8, device="cpu")
    y = tr.init_item_factors(item_side.padded_rows, len(batch.items), 8,
                             torch.Generator().manual_seed(1), cpu)[:len(batch.items)]
    points = torch.as_tensor(rng.standard_normal((600, 4)).astype(np.float32))
    flagship = ALSServingModel(8, True, device="cpu")
    flagship.bulk_load_items([f"i{j}" for j in range(500)],
                             rng.standard_normal((500, 8)).astype(np.float32))
    out = cs.analyze_phase(user_side, item_side, y, points, flagship,
                           np.random.default_rng(2))
    assert modes == ["warn", 0] * 3
    analyser = out["analyser"]
    assert analyser["rc"] == 0 and analyser["unsuppressed"] == 0
    assert analyser["suppressed_by_checker"]["config-key-drift"] == 13
    assert analyser["suppressed_by_checker"]["replicated-collective"] == 1
    # the protocol child: the reference's counts, the six fixtures replayed
    protocol = out["protocol"]
    assert {m: (r["states"], r["transitions"])
            for m, r in protocol["models"].items()} == {"ckpt-generation": (59, 100)}
    assert protocol["depth"] == 12 and protocol["crash_budget"] == 2
    assert len(protocol["replays"]) == 6
    # the cost child at the rehearsal's shapes: the smoke's own numbers
    cost = out["cost"]
    assert cost["score_flops"]["static"] == cs.scan_flops(256, 500, 8) == 2.0 * 256 * 500 * 8
    assert cost["sharded_collective_bytes"]["static"] == y.numel() * 4
    assert cost["sharded_collective_bytes"]["expr"] == "4·y.d0·y.d1"
    windows = out["syncs"]["windows"]
    assert set(windows) == {"als_iteration", "kmeans_train", "top_n_batch"}
    # kmeans_train's argmin; the batched reads through device.to_host
    km_sites = windows["kmeans_train"]["sites"]
    assert any(s.startswith("oryx_tpu_torch/models/kmeans/train.py:")
               for s in km_sites)
    assert any(s.startswith("oryx_tpu_torch/common/device.py:")
               for s in windows["top_n_batch"]["sites"])
    for w in windows.values():
        for site, row in w["sites"].items():
            assert site.startswith("oryx_tpu_torch/") and row["kinds"], (site, row)
    assert out["syncs"]["findings_total"] == 0
