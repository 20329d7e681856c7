"""Checkpoint/generation lifecycle model: offsets commit
only after a generation completes, resume is fingerprint-keyed, and a
restarted trainer must consume exactly the suffix past the committed
offset.

The machine is a single-tier trainer over one input partition holding
``TOTAL`` records. A generation snapshots the head offset when it
starts (``BatchContext.input_offsets``, batch.py:78), runs its
microbatch steps (``layer.py`` ``run_microbatches`` ->
``store_input_offset``), and only a COMPLETED generation's offsets are
checkpointed (``CheckpointStore.save``, checkpoint.py:165) and hence
visible to a restart (``TrainerCheckpointer.restore``,
checkpoint.py:321 -> ``load_latest`` -> fingerprint match at
checkpoint.py:93).

A crash at any point kills the in-flight generation; its partial work
is re-done after resume — the at-least-once story — but the model must
prove offsets never run ahead of applied work (no record skipped) and
that resume with a mismatched fingerprint starts from scratch rather
than adopting a foreign checkpoint.

Variants re-introducing bugs:

* ``commit-before-complete`` — the offset commit is issued when the
  generation STARTS (as if ``store_input_offset`` ran before the
  steps): a crash mid-generation then resumes past records that were
  never applied, and ``no-committed-record-loss`` fires.
* ``resume-ignore-fingerprint`` — restore skips the fingerprint check
  and adopts whatever checkpoint is latest, even one written under a
  different config lineage: ``resume-matches-fingerprint`` fires.
"""

from __future__ import annotations

from oryx_tpu_torch.tools.analyze.protocol.machine import S, Action, Model, Site

TOTAL = 3  # records in the input partition
STEPS = 2  # microbatch steps per generation

VARIANTS = ("commit-before-complete", "resume-ignore-fingerprint")

_LAYER = "oryx_tpu_torch/lambda_rt/layer.py"
_BATCH = "oryx_tpu_torch/lambda_rt/batch.py"
_CKPT = "oryx_tpu_torch/common/checkpoint.py"

SITES = {
    "gen_offsets": Site(_BATCH, "BatchLayer._on_generation", 86,
                        "context.input_offsets"),
    "gen_run": Site(_LAYER, "AbstractLayer._run_generation", 333),
    "gen_fault": Site(_LAYER, "AbstractLayer._run_generation", 339,
                      "faults.maybe_fail"),
    "store_off": Site(_LAYER, "AbstractLayer.store_input_offset", 195),
    "store_call": Site(_LAYER, "AbstractLayer.run_microbatches", 311,
                       "store_input_offset"),
    "fingerprint": Site(_CKPT, "fingerprint", 106,
                        "json.dumps(parts, sort_keys=True"),
    "save": Site(_CKPT, "CheckpointStore.save", 178, "maybe_fail"),
    "load": Site(_CKPT, "CheckpointStore.load_latest", 230, "maybe_fail"),
    "restore": Site(_CKPT, "TrainerCheckpointer.restore", 331),
}


def _initial() -> S:
    return S(
        head=0,        # records applied by completed + in-flight work
        applied=0,     # records applied by COMPLETED generations
        committed=0,   # offset durable in the latest checkpoint
        gen=None,      # in-flight generation: S(start, end, step)
        # latest durable checkpoint: (committed_offset, fingerprint)
        ckpt=(0, "fp-a"),
        fingerprint="fp-a",  # live config lineage
        foreign=False,       # a foreign-lineage checkpoint was planted
        adopted_foreign=False,  # restore took progress from one
        up=True,
    )


def _mk_start_gen(variant: str) -> Action:
    def fire(s: S) -> "S | None":
        if not s.up or s.gen is not None or s.head >= TOTAL:
            return None
        end = min(s.head + 1, TOTAL)
        nxt = s.updated(gen=S(start=s.head, end=end, step=0))
        if variant == "commit-before-complete":
            # BUG: offsets stored/committed at generation start
            nxt = nxt.updated(committed=end, ckpt=(end, s.fingerprint))
        return nxt

    return Action(
        name="gen.start",
        fire=fire,
        vars=frozenset({"trainer"}),
        sites=(SITES["gen_offsets"], SITES["gen_run"]),
    )


def _mk_step() -> Action:
    def fire(s: S) -> "S | None":
        if not s.up or s.gen is None or s.gen.step >= STEPS:
            return None
        return s.updated(gen=s.gen.updated(step=s.gen.step + 1))

    return Action(
        name="gen.step",
        fire=fire,
        vars=frozenset({"trainer"}),
        sites=(SITES["gen_fault"],),
    )


def _mk_complete(variant: str) -> Action:
    def fire(s: S) -> "S | None":
        if not s.up or s.gen is None or s.gen.step < STEPS:
            return None
        nxt = s.updated(head=s.gen.end, applied=s.gen.end, gen=None)
        if variant != "commit-before-complete":
            # HEAD: store_input_offset runs after the last microbatch
            # (layer.py:301) and the checkpoint carries it
            nxt = nxt.updated(
                committed=s.gen.end, ckpt=(s.gen.end, s.fingerprint)
            )
        return nxt

    return Action(
        name="gen.complete",
        fire=fire,
        vars=frozenset({"trainer"}),
        sites=(SITES["store_call"], SITES["store_off"], SITES["save"]),
    )


def _mk_plant_foreign() -> Action:
    def fire(s: S) -> "S | None":
        if s.foreign or s.ckpt[1] != s.fingerprint:
            return None
        # an operator drops in a checkpoint from a different config
        # lineage, claiming MORE progress than this lineage has made
        return s.updated(foreign=True, ckpt=(TOTAL, "fp-b"))

    return Action(
        name="ops.plant_foreign_ckpt",
        fire=fire,
        vars=frozenset({"ckpt-store", "trainer"}),
        writes=frozenset({"ckpt-store"}),
        kind="fault",
        progress=False,
    )


def _mk_crash() -> Action:
    def fire(s: S) -> "S | None":
        if not s.up:
            return None
        return s.updated(up=False, gen=None)

    return Action(
        name="trainer.crash",
        fire=fire,
        vars=frozenset({"trainer"}),
        kind="crash",
        progress=False,
    )


def _mk_restart(variant: str) -> Action:
    def fire(s: S) -> "S | None":
        if s.up:
            return None
        off, fp = s.ckpt
        if variant == "resume-ignore-fingerprint" or fp == s.fingerprint:
            resume = off
        else:
            # HEAD: fingerprint mismatch -> fresh start from this
            # lineage's own durable progress (none adopted)
            resume = 0
        nxt = s.updated(
            up=True, head=resume, applied=resume, committed=resume
        )
        if fp != s.fingerprint and resume > 0:
            nxt = nxt.updated(adopted_foreign=True)
        return nxt

    return Action(
        name="trainer.restart",
        fire=fire,
        vars=frozenset({"trainer", "ckpt-store"}),
        kind="restart",
        sites=(SITES["restore"], SITES["load"], SITES["fingerprint"]),
    )


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _inv_commit_after_complete(s: S) -> "str | None":
    if s.committed > s.applied:
        return (
            f"committed offset {s.committed} ran ahead of applied work "
            f"{s.applied} — offsets must only commit after generation "
            f"completion"
        )
    return None


def _inv_no_committed_loss(s: S) -> "str | None":
    # the resume contract: everything at or past `committed` will be
    # re-read, so records BELOW it must already be applied. A committed
    # offset above `applied` means a crash now skips unapplied records.
    if s.up and s.gen is None and s.committed > s.applied:
        return (
            f"records [{s.applied}, {s.committed}) are committed as "
            f"consumed but were never applied — they are lost to any "
            f"resume"
        )
    return None


def _inv_resume_fingerprint(s: S) -> "str | None":
    if s.adopted_foreign:
        return (
            "trainer adopted a foreign-fingerprint checkpoint on "
            f"restore: resumed at offset {s.applied} under lineage "
            f"{s.fingerprint!r} from a {s.ckpt[1]!r} checkpoint"
        )
    return None


def _live_all_committed(s: S) -> "str | None":
    if s.foreign:
        return None  # foreign plant legitimately stalls this lineage
    if s.committed < TOTAL:
        return (
            f"only {s.committed}/{TOTAL} records committed at fixpoint"
        )
    return None


def build(variant: str = "") -> Model:
    if variant not in ("",) + VARIANTS:
        raise ValueError(f"unknown ckpt-generation variant {variant!r}")
    return Model(
        name="ckpt-generation",
        variant=variant,
        initial=_initial(),
        actions=(
            _mk_start_gen(variant),
            _mk_step(),
            _mk_complete(variant),
            _mk_plant_foreign(),
            _mk_crash(),
            _mk_restart(variant),
        ),
        invariants=(
            ("commit-after-completion", _inv_commit_after_complete),
            ("no-committed-record-loss", _inv_no_committed_loss),
            ("resume-matches-fingerprint", _inv_resume_fingerprint),
        ),
        liveness=("all-records-committed", _live_all_committed),
    )
