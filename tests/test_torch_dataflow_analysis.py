"""The dataflow family of the port's analyser in torch form.

The reference's ``tests/test_dataflow_analysis.py`` cases for the three
features this file covers, restated in torch source (each names the
reference case it restates): ``dtype-widening``, ``replicated-collective``
over the port's mesh (``parallel.mesh.replicated`` copies zipped into a
per-shard loop), and the ``analyze --cost`` static roofline with its CLI.
Its host-device-transfer cases are restated in
``tests/test_torch_static_analysis.py``; its wall-clock gate is not (the
smoke's ``analyze`` line prints the analyser's seconds on the card's
host). Everything here is pure AST — fixtures are parsed, never imported.
"""

from __future__ import annotations

import json
import os
import textwrap

import pytest
import torch

import oryx_tpu_torch
from oryx_tpu_torch.tools.analyze import analyze_project, analyze_source
from oryx_tpu_torch.tools.analyze.core import (
    FileContext,
    ProjectContext,
    build_project,
)
from oryx_tpu_torch.tools.analyze.dataflow import cost_report

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(oryx_tpu_torch.__file__)))
BASELINE = os.path.join(REPO_ROOT, "conf", "analyze-baseline-torch.json")


def _run(src: str, checker: str, **kw):
    findings = analyze_source(textwrap.dedent(src), **kw)
    return [f for f in findings if f.checker == checker]


# ---------------------------------------------------------------------------
# replicated-collective
# ---------------------------------------------------------------------------


_TRAIN_SHAPED = """
    import torch
    from oryx_tpu_torch.parallel.mesh import ShardedRows, replicated

    def _local(y, scols, svals):
        yty = y.T @ y
        ys = y.to(torch.bfloat16)
        yg = ys[scols]                      # gathered by data indices
        return torch.einsum("st,sti->si", svals, yg.float())

    def _solver(y, shards, devices):
        full = y.full() if isinstance(y, ShardedRows) else y
        return [_local(y_d, c, v)           # y copied whole to every shard
                for y_d, (c, v) in zip(replicated(full, devices), shards)]
"""


def test_replicated_collective_fires_on_train_shaped_region():
    """Restates ``test_replicated_collective_fires_on_train_shaped_region``:
    the ROADMAP item 5 shape — a factor table copied whole to every shard
    (``replicated(full, devices)``) while the per-shard function gathers it
    by data indices — priced in the message by the enclosing function's
    parameter it aliases (``full = y.full() ...`` is ``y``)."""
    hits = _run(_TRAIN_SHAPED, "replicated-collective")
    assert len(hits) == 1
    f = hits[0]
    assert f.symbol == "_solver:full" and f.line == 14
    assert "4·y.d0·y.d1" in f.message and "_local(y)" in f.message
    assert "copied to every device" in f.message


def test_replicated_collective_quiet_on_batch_replication():
    """Restates ``test_replicated_collective_quiet_on_batch_replication``:
    the serving scan's clean shape — the model-scaled table is SHARDED;
    the replicated operands are batch-shaped (queries, masks, the LSH
    table: multiplied, compared, their columns picked, never gathered by
    data rows) — deliberate small broadcasts, also through a name bound
    to a conditional copy."""
    hits = _run(
        """
        import torch
        from oryx_tpu_torch.parallel.mesh import replicated

        def _topk(mats, buckets, qs, excl, lut, k):
            devs = mats.devices
            lut_d = replicated(lut, devs) if lut is not None else [None] * len(devs)
            out = []
            for mat, bkt, q, ex, lu in zip(mats.shards, buckets.shards,
                                           replicated(qs, devs),
                                           replicated(excl, devs), lut_d):
                scores = q @ mat.T
                scores.masked_fill_(~lu[:, bkt], float("-inf"))
                scores = torch.where(ex >= 0, float("-inf"), scores)
                out.append(torch.topk(scores, k, dim=1))
            return out
        """,
        "replicated-collective",
    )
    assert hits == []


def test_replicated_collective_fires_on_closure_capture():
    """Restates ``test_replicated_collective_fires_on_closure_capture``: a
    device tensor captured by the per-shard function is read whole by
    every shard with no ``replicated(...)`` line to review."""
    hits = _run(
        """
        import torch

        def build(idx_rows, table_np, dev):
            table = torch.as_tensor(table_np, device=dev)

            def local(idx):
                return table[idx]

            return [local(i) for i in idx_rows.shards]
        """,
        "replicated-collective",
    )
    assert len(hits) == 1
    assert hits[0].symbol == "build.local:capture:table"
    assert "closure-captured" in hits[0].message


# ---------------------------------------------------------------------------
# dtype-widening
# ---------------------------------------------------------------------------


def test_dtype_widening_fires_on_implicit_bf16_f32_mixing():
    """Restates ``test_dtype_widening_fires_on_implicit_bf16_f32_mixing``.
    torch promotes an elementwise op over bf16/int8 and f32 silently; a
    contraction over mixed dtypes it refuses at run time (checked here),
    so that is no finding."""
    hits = _run(
        """
        import torch

        def scan(q, table, dev):
            t = table.to(dev).to(torch.bfloat16)
            w = torch.zeros((4,), device=dev)     # f32 by default
            return t * w                          # silent widening to f32

        def mix(q, table, dev):
            qq = table.to(dev, torch.int8)
            f = torch.ones((4,), device=dev)
            return qq + f                         # int8 + f32: f32

        def contract(q, dev):
            t = torch.zeros((4, 4), device=dev).bfloat16()
            f = torch.ones((4, 4), device=dev)
            return torch.mm(t, f)                 # refused at run time
        """,
        "dtype-widening",
    )
    assert len(hits) == 2
    assert {f.symbol for f in hits} == {"scan:bfloat16", "mix:int8"}
    assert all("silently widens" in f.message for f in hits)
    assert (torch.zeros(4).bfloat16() * torch.ones(4)).dtype == torch.float32
    with pytest.raises(RuntimeError):
        torch.mm(torch.zeros((4, 4)).bfloat16(), torch.ones((4, 4)))


def test_dtype_widening_quiet_on_sanctioned_sites_and_explicit_forms():
    """Restates ``test_dtype_widening_quiet_on_sanctioned_sites_and_explicit_forms``:
    a rescore scope, f32 accumulation through ``out_dtype=`` (the
    reference's ``preferred_element_type``), an explicit ``.float()``, and
    host tensors (the checker reads device scopes only)."""
    hits = _run(
        """
        import torch

        def rescore_exact(q, table, dev):
            t = table.to(dev).bfloat16()
            w = torch.zeros((4,), device=dev)
            return t * w                     # sanctioned rescore site

        def scan_accum(q, table, dev):
            t = table.to(dev).bfloat16()
            q16 = q.to(dev).bfloat16()
            # f32 ACCUMULATION over narrow inputs: the card's matmul recipe
            s = torch.mm(q16, t.T, out_dtype=torch.float32)
            return s * torch.ones((4,), device=dev)

        def scan_explicit(q, table, dev):
            t = table.to(dev).bfloat16()
            t32 = t.float()                  # visible intent, not silent
            w = torch.zeros((4,), device=dev)
            return t32 * w

        def host_only():
            t = torch.ones((4,)).bfloat16()  # host tensors: no HBM traffic
            return t * torch.zeros((4,))
        """,
        "dtype-widening",
    )
    assert hits == []


def test_dtype_widening_is_flow_sensitive_on_late_narrowing():
    """Restates ``test_dtype_widening_is_flow_sensitive_on_late_narrowing``:
    a value narrowed at the END of the scope must not retro-flag the
    earlier pure-f32 arithmetic, while narrow-then-mix still fires."""
    hits = _run(
        """
        import torch

        def accum(q, dev):
            w = torch.ones((4,), device=dev)
            acc = torch.zeros((4,), device=dev)
            acc = acc + w                  # f32 + f32 at this line: quiet
            acc = acc.bfloat16()           # narrowed only on the way out
            return acc

        def still_caught(q, dev):
            w = torch.ones((4,), device=dev)
            acc = torch.zeros((4,), device=dev).bfloat16()
            acc = acc + w                  # bf16 + f32 HERE: fires
            return acc
        """,
        "dtype-widening",
    )
    assert len(hits) == 1 and hits[0].symbol == "still_caught:bfloat16"


def test_dtype_widening_reads_upload_borne_dtypes():
    """The port's own narrow tensors are uploaded from numpy
    (``_QuantSnapshot.build``: an ``np.int8`` slab through
    ``torch.as_tensor``). Mixed elementwise with float32 in the function
    that uploads it, the int8 slab fires; converted with ``.float()``, as
    ``_quant_chunk_scores`` does, it stays quiet."""
    hits = _run(
        """
        import numpy as np
        import torch

        def dequant(rows, scale, dev):
            q8 = torch.as_tensor(rows.astype(np.int8), device=dev)
            s = torch.as_tensor(scale.astype(np.float32), device=dev)
            return q8 * s[:, None]           # int8 * f32: silent widening

        def dequant_empty(n, k, dev):
            q = np.empty((n, k), dtype=np.int8)
            q8 = torch.from_numpy(q).to(dev)
            return q8 + torch.ones((n, k), device=dev)

        def dequant_explicit(rows, scale, dev):
            q8 = torch.as_tensor(rows.astype(np.int8), device=dev)
            s = torch.as_tensor(scale.astype(np.float32), device=dev)
            return q8.float() * s[:, None]   # visible intent
        """,
        "dtype-widening",
    )
    assert {f.symbol for f in hits} == {"dequant:int8", "dequant_empty:int8"}


def test_dtype_widening_reach_stops_at_attribute_borne_dtypes():
    """The checker's reach, pinned: ``_quant_chunk_scores``'s shape, the
    int8 slab read through an attribute (``snap.qmat``) of an object made
    elsewhere, mixed with its float32 scales. No evidence of either dtype
    lies in the function, so even this widening is not seen (README and
    ROADMAP record the limit); the same op on a slab whose dtype the
    function itself shows fires."""
    hits = _run(
        """
        import torch

        def chunk_scores(snap, qs, a, e):
            return qs @ (snap.qmat[a:e] * snap.qscale[a:e][:, None]).T

        def chunk_scores_local(snap, qs, a, e):
            q8 = snap.qmat[a:e].to(torch.int8)
            return qs @ (q8 * snap.qscale[a:e].float()[:, None]).T
        """,
        "dtype-widening",
    )
    assert [f.symbol for f in hits] == ["chunk_scores_local:int8"]


# ---------------------------------------------------------------------------
# --cost: the static roofline
# ---------------------------------------------------------------------------


def test_cost_pins_concrete_matmul_and_einsum():
    """Restates ``test_cost_pins_concrete_matmul_and_einsum``:
    (128,64)@(64,32) = 2·128·64·32 FLOPs, einsum('stk,stj->skj') =
    2·s·t·k·j. Two alternative paths (the bf16 branch of a scoring
    function) price as one call, not as their sum; a ``@`` over host numpy
    arrays is no device program."""
    src = textwrap.dedent(
        """
        import numpy as np
        import torch

        def mm(w):
            a = torch.zeros((128, 64))
            b = torch.zeros((64, 32))
            return a @ b

        def ein(w):
            x = torch.zeros(8, 16, 4)
            return torch.einsum("stk,stj->skj", x, x)

        def score(qs, mat):
            if mat.dtype != torch.bfloat16:
                return qs @ mat.T
            qb = qs.to(torch.bfloat16)
            if mat.device.type == "cuda":
                return torch.mm(qb, mat.T, out_dtype=torch.float32)
            return qb.float() @ mat.float().T

        def host(rows, q):
            r = np.asarray(rows, dtype=np.float32)
            return r @ q
        """
    )
    project = ProjectContext([FileContext("m.py", "m.py", src)])
    rows = {r["program"]: r for r in cost_report(project)}
    assert set(rows) == {"m.mm", "m.ein", "m.score"}
    mm = rows["m.mm"]
    assert mm["flops"].evaluate({}) == 2 * 128 * 64 * 32
    assert mm["hbm_bytes"].evaluate({}) == (128 * 64 + 64 * 32) * 4
    assert rows["m.ein"]["flops"].evaluate({}) == 2 * 8 * 16 * 4 * 4
    score = rows["m.score"]
    assert score["flops"].render() == "2·mat.d0·qs.d0·qs.d1"
    assert score["hbm_bytes"].render() == "4·mat.d0·mat.d1 + 4·qs.d0·qs.d1"


def test_cost_prices_the_als_half_iteration_collective():
    """Restates ``test_cost_prices_the_als_half_iteration_collective``:
    the sharded ALS half-iteration shows collective bytes equal to the
    hand-computed N·k·4 copy of the replicated opposite factor (1M × 50f:
    200 MB per call), priced once in ``solve_side_sharded`` where the
    ``replicated(...)`` call is; the per-shard ``solve_side_blocked``
    prices its Gramian YᵀY at 2·N·k²."""
    project, errors = build_project(
        [os.path.join(REPO_ROOT, "oryx_tpu_torch", "models", "als", "train.py")],
        root=REPO_ROOT,
    )
    assert errors == []
    rows = {r["program"].rsplit(".", 1)[-1]: r for r in cost_report(project)}
    n, k = 1_000_000, 50
    sharded = rows["solve_side_sharded"]
    assert sharded["collective_bytes"].evaluate({"y.d0": n, "y.d1": k}) == n * k * 4
    assert sharded["collective_bytes"].render() == "4·y.d0·y.d1"
    blocked = rows["solve_side_blocked"]
    assert blocked["flops"].render() == "2·y.d0·y.d1^2"
    assert blocked["flops"].evaluate({"y.d0": n, "y.d1": k}) == 2 * n * k * k
    assert not blocked["collective_bytes"]


def test_cli_cost_json_renders_and_binds(capsys):
    """Restates ``test_cli_cost_json_renders_and_binds``, with the scoring
    product of the b256 scan over 1M × 50 beside it; the reference's Pallas
    kernel rows are not ported."""
    from oryx_tpu_torch.tools.analyze.cli import main

    rc = main(["--cost", "--format", "json",
               "--bind", "y.d0=1000000,y.d1=50",
               "--bind", "qs.d0=256,qs.d1=50,mat.d0=1000000,mat.d1=50"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert set(data) == {"programs", "bindings", "parse_errors"}
    progs = {p["program"]: p for p in data["programs"]}
    als = progs["oryx_tpu_torch.models.als.train.solve_side_sharded"]
    assert als["collective_bytes"]["value"] == 1_000_000 * 50 * 4
    assert als["collective_bytes"]["expr"] == "4·y.d0·y.d1"
    score = progs["oryx_tpu_torch.models.als.serving._score"]
    assert score["flops"]["value"] == 2.0 * 256 * 1_000_000 * 50
    assert data["bindings"]["mat.d0"] == 1_000_000


def test_cli_cost_rejects_bad_bindings(capsys):
    """Restates ``test_cli_cost_rejects_bad_bindings``."""
    from oryx_tpu_torch.tools.analyze.cli import main

    for bad, text in (("nonsense", "needs SYM=VALUE"),
                      ("y.d0=many", "is not numeric")):
        with pytest.raises(SystemExit) as exc:
            main(["--cost", "--bind", bad])
        assert exc.value.code == 2
        assert text in capsys.readouterr().err


def test_cli_cost_refuses_findings_mode_flags(capsys):
    """Restates ``test_cli_cost_refuses_findings_mode_flags``: --cost
    rejects findings-mode flags rather than silently ignoring them, and
    --bind without --cost is equally meaningless."""
    from oryx_tpu_torch.tools.analyze.cli import main

    for flags in (["--cost", "--changed"],
                  ["--cost", "--update-baseline"],
                  ["--cost", "--checker", "dtype-widening"],
                  ["--cost", "--baseline", "b.json"],
                  ["--cost", "--no-baseline"],
                  ["--cost", "--format", "sarif"]):
        assert main(flags) == 2, flags
        assert "does not combine" in capsys.readouterr().err
    assert main(["--bind", "y.d0=5"]) == 2
    assert "--bind only applies to --cost" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the port's gate
# ---------------------------------------------------------------------------


def test_new_checkers_clean_at_head_with_train_copy_baselined():
    """Restates ``test_new_checkers_clean_at_head_with_train_allgather_baselined``:
    zero unsuppressed findings across the three dataflow checkers and
    protocol-model-drift over the port, with the known replicated copy of
    the opposite factor in ``solve_side_sharded`` present and justified in
    the port's baseline (pointing at ROADMAP item 5)."""
    result = analyze_project(
        [os.path.join(REPO_ROOT, "oryx_tpu_torch")],
        root=REPO_ROOT,
        baseline_path=BASELINE,
        checkers=["replicated-collective", "host-device-transfer",
                  "dtype-widening", "protocol-model-drift"],
    )
    assert result.parse_errors == []
    assert result.unsuppressed == [], "\n" + "\n".join(
        f.render() for f in result.unsuppressed)
    flagged = [f for f in result.suppressed
               if f.checker == "replicated-collective"]
    assert [(f.path, f.symbol) for f in flagged] == [
        ("oryx_tpu_torch/models/als/train.py", "solve_side_sharded:full")]
    assert "ROADMAP item 5" in flagged[0].justification
    assert not [f for f in result.findings
                if f.checker in ("dtype-widening", "protocol-model-drift")]
