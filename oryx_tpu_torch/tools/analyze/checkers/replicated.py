"""replicated-collective: model-scaled tables copied whole to every shard.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/replicated.py``
under the reference's id and version, rewritten for the port's mesh
(``parallel/mesh.py``), which has no ``shard_map``: a per-shard loop zips
the copies ``replicated(value, devices)`` makes (one whole copy of
``value`` on every shard's device, the counterpart of an input spec'd
``P()``) with the shards, and calls per-shard code with them
(``dataflow.shard_regions``).

Distributed-ALS routing (MLlib's block layout, arXiv:1505.06807) treats
per-iteration collective bytes as THE scaling budget. For batch-shaped
operands (queries, masks, centres) a whole copy per shard is the design;
for a factor TABLE whose size scales with a model dimension (N·k) it is
the classic scaling bug — ROADMAP item 5's replicated-``y`` copy in
``solve_side_sharded``, invisible to every control-flow checker.

An operand is *model-scaled* when the per-shard code it reaches (the loop
body, a per-shard call's parameter, or one positional hop beyond) gathers
it by data rows (``y[cols]``, ``torch.index_select``, ``torch.take``) or
forms its self-Gramian (``y.T @ y``) — the factor-table signature that
batch operands never show. The other direction: a per-shard function
defined in the enclosing scope that closes over a device tensor it gathers
reads that whole table from every shard, with no ``replicated(...)`` line
to review. Findings carry the estimated per-call copy byte polynomial
(``4·y.d0·y.d1``), the same expression ``analyze --cost`` evaluates under
``--bind``.
"""

from __future__ import annotations

import ast

from oryx_tpu_torch.tools.analyze.dataflow import (
    _direct_gather_evidence,
    priced_name,
    replicated_bytes,
    replicated_capture_names,
    replicated_tables,
    shard_regions,
)

ID = "replicated-collective"


class ReplicatedCollectiveChecker:
    id = ID
    version = 1

    def check(self, project) -> list:
        out = []
        for region in shard_regions(project):
            fctx = region.fctx
            for call, value, _, reached in replicated_tables(project, region):
                name = ast.unparse(value)
                est = replicated_bytes(priced_name(region, value)).render()
                out.append(fctx.finding(
                    ID, call,
                    f"replicated `{name}` enters the per-shard code of "
                    f"`{region.enclosing_qual}` ({reached}) whole on every "
                    f"shard's device: the full table is copied to every "
                    f"device each call (~{est} B) — ship only the rows each "
                    "shard needs (routing table) or shard the table",
                    symbol=f"{region.enclosing_qual}:{name}",
                ))
            for fn, name in replicated_capture_names(project, region):
                if not _direct_gather_evidence(fctx, fn, name):
                    continue
                qual = fctx.qualname_of.get(fn, fn.name)
                est = replicated_bytes(name).render()
                out.append(fctx.finding(
                    ID, region.loop,
                    f"device tensor `{name}` is closure-captured by the "
                    f"per-shard function `{qual}`: every shard reads the "
                    f"whole table (~{est} B per call) with no replicated() "
                    "line to review — pass it row-sharded instead",
                    symbol=f"{qual}:capture:{name}",
                ))
        return out
