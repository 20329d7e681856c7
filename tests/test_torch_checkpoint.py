"""The port's trainer checkpoints and blocked-layout cache, held to the
reference's tests and to the reference itself.

* The cases of ``tests/test_checkpoint.py`` whose bodies name no trainer
  (the store, GC, fingerprint, config gating, file format) run the
  reference's own bodies on the port's modules (:func:`_mirror`). The
  train, fault and ``ALSUpdate`` cases import the reference trainer inside
  their bodies, so they are restated here on the port, with the
  reference's Y₀ for ``key=jax.random.PRNGKey(1)`` passed as ``init_y``.
* Cross-package: a checkpoint file written by either package loads in the
  other; the port resumes from the reference's own mid-train checkpoint
  and lands within 1e-5 of the reference's uninterrupted factors; both
  ``ALSUpdate``s name the same checkpoint for the same batch and settings.
* The layout-cache cases of ``tests/test_gramian_kernel.py`` on the port,
  and the port's ``full`` and ``delta`` slabs against the reference's
  ``make_blocked_side`` / ``_delta_blocked_side``, schedules included.
"""

from __future__ import annotations

import os
import threading

import jax
import numpy as np
import pytest
import torch

from oryx_tpu.common import checkpoint as ref_ck
from oryx_tpu.common import config as ref_cfg
from oryx_tpu.models.als import train as ref_tr
from oryx_tpu.models.als.update import ALSUpdate as RefALSUpdate
from oryx_tpu_torch import state
from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import blackbox
from oryx_tpu_torch.common import checkpoint as ck
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.common import faults
from oryx_tpu_torch.common import metrics as metrics_mod
from oryx_tpu_torch.models.als import data as als_data
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.models.als.update import ALSUpdate
from test_gramian_kernel import _skewed_batch
from test_torch_observability import _mirror

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

_CK = _mirror("test_checkpoint.py", {"ck": ck, "cfg": cfg, "faults": faults,
                                      "metrics_mod": metrics_mod})
_CK_CASES = [
    "test_store_roundtrip_preserves_arrays_meta_and_dtype",
    "test_store_newest_wins_and_fingerprints_are_isolated",
    "test_corrupt_or_partial_checkpoint_skipped_never_trusted",
    "test_gc_keeps_last_n_per_fingerprint_with_total_cap",
    "test_fingerprint_sensitivity",
    "test_from_config_gating",
    "test_checkpoint_file_format_is_versioned_and_self_describing",
]
for _name in _CK_CASES:
    globals()[_name] = _CK[_name]
# restated below on the port (their bodies import the reference trainer)
_RESTATED = {
    "test_als_train_kill_and_resume_matches_uninterrupted_run",
    "test_mismatched_fingerprint_or_shape_never_resumes",
    "test_chaos_ckpt_save_failures_degrade_never_kill_training",
    "test_chaos_ckpt_load_failure_trains_from_scratch",
    "test_alsupdate_build_model_resumes_via_data_fingerprint",
}
FP, FP2 = _CK["FP"], _CK["FP2"]
_counter = _CK["_counter"]


def test_every_reference_case_is_mirrored_or_restated():
    assert {n for n in _CK if n.startswith("test_")} == set(_CK_CASES) | _RESTATED
    for name in _CK_CASES:
        assert globals()[name].__globals__["ck"] is ck
    assert _CK["_arrays"].__globals__["ck"] is ck


# ---------------------------------------------------------------------------
# TrainerCheckpointer + als_train resume (restated on the port)
# ---------------------------------------------------------------------------


def _rating_batch(nnz=20_000, n_users=500, n_items=200, seed=0):
    """``tests/test_checkpoint.py``'s batch, as a port RatingBatch."""
    b = _CK["_rating_batch"](nnz, n_users, n_items, seed)
    return RatingBatch(b.rows, b.cols, b.vals, b.users, b.items)


def _ref_y0(batch, features, key):
    """The reference's Y₀ for ``key``: what its ``als_train`` starts from."""
    n_items = len(batch.items)
    block_i = ref_tr._even_block(n_items, features, 1, None)
    return state.init_y(ref_tr._init_factors(
        ref_tr._padded_rows_for(n_items, block_i), n_items, features, key),
        device="cpu")


def _train_kwargs(batch, iterations=6, features=8):
    return dict(features=features, lam=0.001, alpha=1.0, implicit=True,
                iterations=iterations,
                init_y=_ref_y0(batch, features, jax.random.PRNGKey(1)),
                device="cpu")


def test_als_train_kill_and_resume_matches_uninterrupted_run(tmp_path):
    """THE resume contract: train with checkpoints, delete everything past
    the mid-train checkpoint (= the state a kill -9 would leave), retrain
    — the resumed run redoes only the missing iterations and lands on the
    uninterrupted run's exact factors."""
    batch = _rating_batch()
    kwargs = _train_kwargs(batch)
    x_plain, y_plain = tr.als_train(batch, **kwargs)

    store = ck.CheckpointStore(tmp_path, keep=4)
    cp = ck.TrainerCheckpointer(store, FP, interval=2)
    timings: dict = {}
    x1, y1 = tr.als_train(batch, timings=timings, checkpointer=cp, **kwargs)
    # checkpointing changes nothing about the result
    assert torch.equal(x_plain, x1) and torch.equal(y_plain, y1)
    assert timings["ckpt_resumed_from"] == 0
    assert store.steps(FP) == [2, 4, 6]  # interval saves + the final one
    assert timings["ckpt_wait_s"] < 0.5, timings
    assert len(timings["iter_s"]) == 6

    # "kill" after step 4: drop the final checkpoint, resume
    resumes_before = _counter("oryx_checkpoint_resumes_total")
    for fp, step, path in store.entries():
        if step == 6:
            os.unlink(path)
    cp2 = ck.TrainerCheckpointer(store, FP, interval=2)
    t2: dict = {}
    x2, y2 = tr.als_train(batch, timings=t2, checkpointer=cp2, **kwargs)
    assert t2["ckpt_resumed_from"] == 4  # redid exactly 2 of 6 iterations
    assert len(t2["iter_s"]) == 2
    assert _counter("oryx_checkpoint_resumes_total") == resumes_before + 1
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5, rtol=1e-5)

    # crash between train end and publish: resume-at-complete redoes zero
    cp3 = ck.TrainerCheckpointer(store, FP, interval=2)
    t3: dict = {}
    x3, _ = tr.als_train(batch, timings=t3, checkpointer=cp3, **kwargs)
    assert t3["ckpt_resumed_from"] == 6 and t3["iter_s"] == []
    assert torch.equal(x2, x3)
    # the item pack was still joined, and its timings written
    assert {"pack_s", "pack_item_s", "blocks"} <= set(t3)
    assert not any(t.name.startswith("oryx-als-pack")
                   for t in threading.enumerate())


def test_mismatched_fingerprint_or_shape_never_resumes(tmp_path):
    """A checkpoint from different data (fingerprint) or different shapes
    (a hyperparameter that slipped past the fingerprint) is never loaded
    into the wrong training."""
    batch = _rating_batch()
    store = ck.CheckpointStore(tmp_path, keep=4)
    cp = ck.TrainerCheckpointer(store, FP, interval=2)
    tr.als_train(batch, checkpointer=cp, **_train_kwargs(batch))
    # different fingerprint: fresh start
    other = ck.TrainerCheckpointer(store, FP2, interval=2)
    t: dict = {}
    tr.als_train(batch, timings=t, checkpointer=other, **_train_kwargs(batch))
    assert t["ckpt_resumed_from"] == 0
    # same fingerprint, different factor width: shape guard refuses it
    wrong = ck.TrainerCheckpointer(store, FP, interval=2)
    t2: dict = {}
    tr.als_train(batch, timings=t2, checkpointer=wrong,
                 **_train_kwargs(batch, features=4))
    assert t2["ckpt_resumed_from"] == 0


def test_chaos_ckpt_save_failures_degrade_never_kill_training(tmp_path):
    """ckpt.save=fail:2 — the first two saves are injected to fail;
    training completes with the SAME result, failures are counted, and the
    schedule's later saves land on disk."""
    batch = _rating_batch()
    kwargs = _train_kwargs(batch, iterations=6)
    x_plain, _ = tr.als_train(batch, **kwargs)
    store = ck.CheckpointStore(tmp_path, keep=4)
    cp = ck.TrainerCheckpointer(store, FP, interval=2)
    failures_before = _counter("oryx_checkpoint_save_failures_total")
    faults.arm("ckpt.save=fail:2", seed=0)
    try:
        x, _ = tr.als_train(batch, checkpointer=cp, **kwargs)
    finally:
        faults.disarm()
    assert torch.equal(x_plain, x)
    assert _counter(
        "oryx_checkpoint_save_failures_total"
    ) == failures_before + 2
    # saves 1-2 (steps 2, 4) were injected away; save 3 (step 6) landed
    assert store.steps(FP) == [6]
    assert any(e["kind"] == "ckpt.save_failure" for e in blackbox.events())


def test_chaos_ckpt_load_failure_trains_from_scratch(tmp_path):
    batch = _rating_batch()
    kwargs = _train_kwargs(batch, iterations=4)
    store = ck.CheckpointStore(tmp_path, keep=4)
    tr.als_train(
        batch, checkpointer=ck.TrainerCheckpointer(store, FP, 2), **kwargs
    )
    assert store.steps(FP)
    faults.arm("ckpt.load=fail:1", seed=0)
    try:
        cp = ck.TrainerCheckpointer(store, FP, interval=2)
        t: dict = {}
        x, _ = tr.als_train(batch, timings=t, checkpointer=cp, **kwargs)
    finally:
        faults.disarm()
    assert t["ckpt_resumed_from"] == 0  # degraded to a fresh start, no raise
    assert tuple(x.shape) == (500, 8)


def _als_config(tmp_path, package=cfg, **extra):
    overlay = {
        "oryx.als.iterations": 4,
        "oryx.als.hyperparams.features": 6,
        "oryx.ml.eval.test-fraction": 0.0,
        "oryx.batch.checkpoint.enabled": True,
        "oryx.batch.checkpoint.dir": str(tmp_path / "ckpt"),
        "oryx.batch.checkpoint.interval-iterations": 2,
    }
    overlay.update(extra)
    return package.overlay_on(overlay, package.get_default())


def test_alsupdate_build_model_resumes_via_data_fingerprint(tmp_path):
    """The MLUpdate/ALSUpdate path end to end: a re-run generation (same
    data, same hyperparams — what a killed-and-restarted batch layer
    produces) resumes from its checkpoint instead of retraining, and the
    resume is observable in the store's meta and the counters."""
    update = ALSUpdate(_als_config(tmp_path), device="cpu")
    data = [KeyMessage(None, ln) for ln in _CK["_als_lines"]()]
    (tmp_path / "c0").mkdir()
    pmml = update.build_model(None, data, [6, 0.001, 1.0], tmp_path / "c0")
    assert pmml is not None
    store = ck.CheckpointStore(tmp_path / "ckpt")
    entries = store.entries()
    assert entries, "no checkpoints written by the generation"
    fp = entries[-1][0]
    final = store.load_latest(fp)
    assert final.meta["completed"] == 4 and final.meta["resumed_from"] == 0

    # the restarted generation: same data + hyperparams -> same fingerprint.
    # Simulate the kill-at-step-2 state by dropping the final checkpoint;
    # the re-run must resume mid-training and redo only iterations 3-4
    for f, step, path in store.entries():
        if f == fp and step == 4:
            os.unlink(path)
    resumes_before = _counter("oryx_checkpoint_resumes_total")
    (tmp_path / "c1").mkdir()
    pmml2 = update.build_model(None, data, [6, 0.001, 1.0], tmp_path / "c1")
    assert pmml2 is not None
    assert _counter("oryx_checkpoint_resumes_total") == resumes_before + 1
    final2 = store.load_latest(fp)
    assert final2.meta["completed"] == 4
    assert final2.meta["resumed_from"] == 2  # only the lost interval redone
    # the second build reused the first's packed layout
    record = update.report["candidates"]["c1"]
    assert record["pack_modes"] == {"user": "reused", "item": "reused"}

    # different hyperparameters = different fingerprint = no cross-resume
    (tmp_path / "c2").mkdir()
    update.build_model(None, data, [6, 0.01, 1.0], tmp_path / "c2")
    fps = {e[0] for e in store.entries()}
    assert len(fps) == 2


# ---------------------------------------------------------------------------
# Cross-package: files, resume, fingerprints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_files_load_in_the_other_package(tmp_path, writer):
    arrays = _CK["_arrays"](5)
    arrays["counts"] = np.arange(9, dtype=np.int64)
    meta = {"completed": 3, "note": "x"}
    save, load = ((ref_ck, ck) if writer == "reference" else (ck, ref_ck))
    path = save.CheckpointStore(tmp_path).save(FP, 3, arrays, meta)
    got = load.CheckpointStore(tmp_path).load_latest(FP)
    assert got is not None and got.path == path and got.step == 3
    assert got.meta == meta
    assert set(got.arrays) == set(arrays)
    for name, a in arrays.items():
        assert got.arrays[name].dtype == a.dtype
        assert np.array_equal(got.arrays[name], a)


def test_port_resumes_from_the_references_checkpoint(tmp_path):
    """The reference trains 4 iterations with a checkpoint every 2; its
    final file is dropped (a kill after step 2); the port resumes from the
    reference's step-2 file and ends within 1e-5 of the reference's
    uninterrupted factors (float32, other summation order)."""
    batch = _CK["_rating_batch"]()
    key = jax.random.PRNGKey(1)
    ref_kwargs = dict(features=8, lam=0.001, alpha=1.0, implicit=True,
                      iterations=4, key=key)
    ref_store = ref_ck.CheckpointStore(tmp_path, keep=4)
    ref_x, ref_y = ref_tr.als_train(
        batch, checkpointer=ref_ck.TrainerCheckpointer(ref_store, FP, 2),
        **ref_kwargs)
    assert ref_store.steps(FP) == [2, 4]
    os.unlink(ref_store.entries()[-1][2])

    cp = ck.TrainerCheckpointer(ck.CheckpointStore(tmp_path, keep=4), FP, 2)
    t: dict = {}
    x, y = tr.als_train(_rating_batch(), timings=t, checkpointer=cp,
                        **_train_kwargs(batch, iterations=4))
    assert t["ckpt_resumed_from"] == 2 and len(t["iter_s"]) == 2
    for got, ref in ((x, ref_x), (y, ref_y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                                   atol=1e-5, rtol=1e-5)
    # the port's final checkpoint loads in the reference
    final = ref_store.load_latest(FP)
    assert final.step == 4 and final.meta["resumed_from"] == 2
    assert np.array_equal(final.arrays["x"], x.numpy())


def test_both_updaters_name_the_same_checkpoint(tmp_path):
    """The same lines and hyperparameters through both packages'
    ``ALSUpdate.build_model``: the same data fingerprint, hence the same
    checkpoint file names."""
    lines = _CK["_als_lines"]()
    (tmp_path / "port" / "c").mkdir(parents=True)
    (tmp_path / "ref" / "c").mkdir(parents=True)
    port = ALSUpdate(_als_config(tmp_path / "port"), device="cpu")
    port.build_model(None, [KeyMessage(None, ln) for ln in lines],
                     [6, 0.001, 1.0], tmp_path / "port" / "c")
    ref = RefALSUpdate(_als_config(tmp_path / "ref", ref_cfg))
    from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage

    ref.build_model(None, [RefKeyMessage(None, ln) for ln in lines],
                    [6, 0.001, 1.0], tmp_path / "ref" / "c")
    names = [sorted(p.name for p in (tmp_path / d / "ckpt").iterdir())
             for d in ("port", "ref")]
    assert names[0] and names[0] == names[1]


# ---------------------------------------------------------------------------
# The layout cache (the cases of tests/test_gramian_kernel.py, on the port)
# ---------------------------------------------------------------------------


def _port_batch(batch):
    return RatingBatch(batch.rows, batch.cols, batch.vals, batch.users,
                       batch.items)


def _prepare(batch, k, cache=None):
    return tr.prepare_blocked(_port_batch(batch), k, cache=cache, device="cpu")


def _schedules_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(p.work, q.work) and torch.equal(p.split, q.split)
        and (p.units, p.split_units, p.unit_entries, p.max_entries_per_unit,
             p.block, p.slots, p.slot_width)
        == (q.units, q.split_units, q.unit_entries, q.max_entries_per_unit,
            q.block, q.slots, q.slot_width)
        for p, q in zip(a, b))


def _sides_equal(a, b) -> bool:
    """Slabs, geometry and the gather-Gramian schedules, bit for bit."""
    return all(
        np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
        for f in ("srows", "scols", "svals", "slens")
    ) and (a.block, a.n_blocks, a.slot_width, a.slot_chunk, a.n_rows) == (
        b.block, b.n_blocks, b.slot_width, b.slot_chunk, b.n_rows
    ) and _schedules_equal(a.gg_schedules, b.gg_schedules)


def _appended(batch, rows, cols):
    return RatingBatch(
        np.concatenate([batch.rows, np.asarray(rows, np.int32)]),
        np.concatenate([batch.cols, np.asarray(cols, np.int32)]),
        np.concatenate([batch.vals, np.ones(len(rows), np.float32)]),
        batch.users, batch.items)


def test_layout_cache_reuses_unchanged_batch():
    batch, k = _skewed_batch(11)
    cache = tr.BlockedLayoutCache()
    u1, i1 = _prepare(batch, k, cache)
    assert cache.last_modes == {"user": "full", "item": "full"}
    u2, i2 = _prepare(batch, k, cache)
    assert cache.last_modes == {"user": "reused", "item": "reused"}
    # the same sides (no re-pack, no re-upload, the same schedules)
    assert u2 is u1 and i2 is i1


def test_layout_cache_delta_equals_full_pack():
    """An appended generation's incremental pack must be bit-identical to a
    from-scratch pack of the full batch — slabs, geometry, schedules."""
    batch, k = _skewed_batch(12)
    rng = np.random.default_rng(99)
    cache = tr.BlockedLayoutCache()
    _prepare(batch, k, cache)
    extra = 60
    batch2 = _appended(batch, rng.integers(0, 5, extra),
                       rng.integers(0, len(batch.items), extra))
    u_delta, i_delta = _prepare(batch2, k, cache)
    assert cache.last_modes == {"user": "delta", "item": "delta"}
    u_full, i_full = _prepare(batch2, k)
    assert _sides_equal(u_delta, u_full)
    assert _sides_equal(i_delta, i_full)
    # and a THIRD generation appends on top of the delta result
    batch3 = _appended(batch2, [7, 8], [1, 2])
    u3, _ = _prepare(batch3, k, cache)
    assert cache.last_modes["user"] == "delta"
    assert _sides_equal(u3, _prepare(batch3, k)[0])


def test_layout_cache_delta_on_production_row_sorted_batches():
    """New interactions for mid-order users land MID-ARRAY after the
    production pipeline's row sort; the cache must still recognise the
    extension and take the delta path — through the port's own
    aggregate/build_rating_batch."""
    k = 8
    rng = np.random.default_rng(21)
    lines1 = [
        f"u{u:03d},i{rng.integers(0, 40):02d},1,{n}"
        for n, u in enumerate(rng.integers(0, 120, 900))
    ]

    def build(lines):
        return als_data.build_rating_batch(
            als_data.aggregate(als_data.parse_lines(lines), True, False, 1e-5))

    b1 = build(lines1)
    seen = set(zip(b1.rows.tolist(), b1.cols.tolist()))
    extra = []
    for j in range(6):
        u = 60 + j
        i = next(i for i in range(40)
                 if (b1.users.id_to_index[f"u{u:03d}"],
                     b1.items.id_to_index[f"i{i:02d}"]) not in seen)
        extra.append(f"u{u:03d},i{i:02d},1,{10_000 + j}")
    b2 = build(lines1 + extra)
    n1 = len(b1.rows)
    assert not (np.array_equal(b1.rows, b2.rows[:n1])
                and np.array_equal(b1.cols, b2.cols[:n1]))
    cache = tr.BlockedLayoutCache()
    tr.prepare_blocked(b1, k, cache=cache, device="cpu")
    u_delta, i_delta = tr.prepare_blocked(b2, k, cache=cache, device="cpu")
    assert cache.last_modes == {"user": "delta", "item": "delta"}
    u_full, i_full = tr.prepare_blocked(b2, k, device="cpu")
    assert _sides_equal(u_delta, u_full)
    assert _sides_equal(i_delta, i_full)


def test_layout_cache_full_repack_on_changed_history():
    """Changed historical values (e.g. time decay rewriting strengths) must
    fall back to a correct full pack, not a wrong delta."""
    batch, k = _skewed_batch(13)
    cache = tr.BlockedLayoutCache()
    _prepare(batch, k, cache)
    decayed = RatingBatch(batch.rows, batch.cols,
                          batch.vals * np.float32(0.95),
                          batch.users, batch.items)
    u, i = _prepare(decayed, k, cache)
    assert cache.last_modes == {"user": "full", "item": "full"}
    assert _sides_equal(u, _prepare(decayed, k)[0])


def test_als_train_overlap_timings_and_cache_stability():
    """als_train reports the pack cost that blocked the critical path and
    the cache modes; a second generation over the same batch reuses the
    cached layout and produces identical factors."""
    batch, k = _skewed_batch(14)
    b = _port_batch(batch)
    y0 = _ref_y0(batch, k, jax.random.PRNGKey(1))
    cache = tr.BlockedLayoutCache()
    tm1: dict = {}
    x1, y1 = tr.als_train(b, k, 0.01, 1.0, True, iterations=2, init_y=y0,
                          layout_cache=cache, timings=tm1, device="cpu")
    assert {"pack_s", "pack_user_s", "pack_item_s", "pack_wait_s"} <= set(tm1)
    assert tm1["pack_modes"] == {"user": "full", "item": "full"}
    assert tm1["pack_s"] == pytest.approx(
        tm1["pack_user_s"] + tm1["pack_wait_s"], abs=2e-3)
    tm2: dict = {}
    x2, y2 = tr.als_train(b, k, 0.01, 1.0, True, iterations=2, init_y=y0,
                          layout_cache=cache, timings=tm2, device="cpu")
    assert tm2["pack_modes"] == {"user": "reused", "item": "reused"}
    assert torch.equal(x1, x2) and torch.equal(y1, y2)


@pytest.mark.parametrize("grow_s", [False, True])
def test_full_and_delta_slabs_equal_the_references(grow_s):
    """The port's ``full`` pack and its ``delta`` repack give the
    reference's slabs bit for bit on the same arrays; the delta side's
    schedules equal a full pack's — the affected blocks' rebuilt, the
    others carried over, or all rebuilt when S grew (``grow_s``: the
    appended entries all go to the fullest block's hot rows)."""
    batch, k = _skewed_batch(15)
    rng = np.random.default_rng(5)
    # few enough entries that the auto slot width T holds; the hot rows
    # sit in block 0, the fullest; rows 64+ in blocks with spare slots
    extra = 70 if grow_s else 40
    rows = rng.integers(0, 5, extra) if grow_s else rng.integers(64, 240, extra)
    batch2 = _appended(batch, rows, rng.integers(0, len(batch.items), extra))
    args = (len(batch.users), 64, None, None, 1)
    ref_old = ref_tr.make_blocked_side(batch.rows, batch.cols, batch.vals,
                                       *args, features=k, keep_np=True)
    old = tr.make_blocked_side(batch.rows, batch.cols, batch.vals, *args,
                               features=k, keep_np=True, device="cpu")
    appended = batch2.rows[len(batch.rows):]
    ref_new = ref_tr._delta_blocked_side(ref_old, batch2.rows, batch2.cols,
                                         batch2.vals, *args, k, appended)
    new = tr._delta_blocked_side(old, batch2.rows, batch2.cols, batch2.vals,
                                 *args, k, appended, device="cpu")
    full = tr.make_blocked_side(batch2.rows, batch2.cols, batch2.vals, *args,
                                features=k, device="cpu")
    assert ref_new is not None and new is not None
    assert (new.np_slabs[0].shape[1] > old.np_slabs[0].shape[1]) == grow_s
    for f in ("srows", "scols", "svals", "slens"):
        for port_side, ref_side in ((old, ref_old), (new, ref_new)):
            got, want = getattr(port_side, f).numpy(), np.asarray(
                getattr(ref_side, f))
            assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert _sides_equal(new, full)
    # the cached host masters were not written: the old side is intact
    assert _sides_equal(old, tr.make_blocked_side(
        batch.rows, batch.cols, batch.vals, *args, features=k, device="cpu"))


def test_delta_trained_factors_equal_a_fresh_packs():
    """A train from the ``delta`` sides gives the factors of a train from
    a fresh pack of the same arrays, bit for bit."""
    batch, k = _skewed_batch(16)
    rng = np.random.default_rng(6)
    batch2 = _port_batch(_appended(batch, rng.integers(0, 240, 30),
                                   rng.integers(0, len(batch.items), 30)))
    y0 = _ref_y0(batch, k, jax.random.PRNGKey(2))
    cache = tr.BlockedLayoutCache()
    kw = dict(iterations=2, init_y=y0, device="cpu", fused_gramian=True,
              spd_kernel=True)
    tr.als_train(_port_batch(batch), k, 0.01, 1.0, True, layout_cache=cache,
                 **kw)
    t: dict = {}
    x1, y1 = tr.als_train(batch2, k, 0.01, 1.0, True, layout_cache=cache,
                          timings=t, **kw)
    assert t["pack_modes"] == {"user": "delta", "item": "delta"}
    x2, y2 = tr.als_train(batch2, k, 0.01, 1.0, True, **kw)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)


# ---------------------------------------------------------------------------
# The writer's fetch
# ---------------------------------------------------------------------------


def test_submit_snapshots_cpu_tensors_and_numpy(tmp_path):
    """The writer takes CPU tensors and numpy arrays alike, and the saved
    file holds what was submitted; the module itself imports no torch."""
    store = ck.CheckpointStore(tmp_path)
    cp = ck.TrainerCheckpointer(store, FP, interval=1)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    y = np.ones((2, 3), np.float32)
    cp.submit(1, {"x": x[:3], "y": y})
    cp.finish()
    got = store.load_latest(FP)
    assert np.array_equal(got.arrays["x"], x[:3].numpy())
    assert np.array_equal(got.arrays["y"], y)
    assert ck._cuda_tensors({"x": x, "y": y}) == {}
    assert "torch" not in vars(ck)


# ---------------------------------------------------------------------------
# The smoke's phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_smoke_als_durability_phase_at_a_small_size(monkeypatch):
    """``chip_smoke.als_durability_phase`` on 20,000 users × 1,000 items
    and 60,000 lines at k = 8 (three user blocks), the generation pair on
    the first 2,000 users' lines, every check as strict as on the card: the
    fused path's plain versions stand in for the kernels, each call counted
    at its shape as the wrappers count launches; the card-only calls
    (synchronize, device memory) stand in as no-ops."""
    import chip_smoke as cs
    from oryx_tpu_torch.ml import mlupdate
    from oryx_tpu_torch.models.als import update as als_update
    from oryx_tpu_torch.ops import kernels as K

    cpu = torch.device("cpu")
    for mod in (cs, tr, mlupdate, als_update):
        monkeypatch.setattr(mod, "resolve", lambda device=None: cpu)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(tr, "_resolve_paths", lambda *a: (True, True))
    gg, spd = tr.gather_gramian_accumulate, tr.spd_solve_batched

    def counted_gg(*args, **kwargs):
        K._count("gather_gramian_accumulate", cs.gg_key(args, kwargs))
        return gg(*args, **kwargs)

    def counted_spd(a, b):
        K._count("spd_solve_batched", tuple(b.shape),
                 "spd_solve_batched." + K.spd_variant(b.shape[1]))
        return spd(a, b)

    monkeypatch.setattr(tr, "gather_gramian_accumulate", counted_gg)
    monkeypatch.setattr(tr, "spd_solve_batched", counted_spd)
    for name, value in dict(N_USERS=20_000, N_ITEMS=1_000, NNZ=60_000,
                            FEATURES=8, DURABILITY_USERS=2_000).items():
        monkeypatch.setattr(cs, name, value)
    lines = cs.synthetic_lines(np.random.default_rng(cs.SEED))
    batch = als_data.prepare(lines, implicit=True)
    user_side, item_side = tr.prepare_blocked(batch, 8, device="cpu")
    assert user_side.n_blocks == 3
    y0 = tr.init_item_factors(item_side.padded_rows, len(batch.items), 8,
                              torch.Generator().manual_seed(cs.SEED + 1), cpu)
    x, y = tr.als_train(batch, 8, cs.LAM, cs.ALPHA, True, cs.ITERATIONS,
                        init_y=y0, device="cpu")
    durability_lines = [ln for ln in lines
                        if int(ln[1:ln.index(",")]) < 2_000]
    out = cs.als_durability_phase(batch, x, y, user_side, item_side,
                                  durability_lines, np.random.default_rng(3))
    ckpt = out["checkpoint"]
    assert ckpt["store_steps"] == [1, 2, 3]
    assert ckpt["resumed"]["bit_equal"] and ckpt["resumed"]["max_abs_diff"] == 0
    assert ckpt["resumed_final"]["launches"] == {
        "gather_gramian_accumulate": 0, "spd_solve_batched": 0}
    assert ckpt["counters"]["save_failures"] == 0
    cache = out["layout_cache"]
    assert [r["pack_modes"]["user"] for r in cache["runs"].values()] == [
        "full", "delta", "reused"]
    assert cache["affected_blocks"] == {"user": 3, "item": 1}
    assert cache["one_block"]["affected_blocks"]["user"] == 1
    gen = out["generation"]
    assert gen["first"]["stamp"]["origin"] == "scratch"
    assert gen["restart"]["stamp"]["origin"] == "resume"
    assert gen["restart"]["stamp"]["generation"] == gen["first"]["stamp"]["generation"]
    blocks = user_side.n_blocks + item_side.n_blocks
    # checkpointed 3, resumed 2, final 0, cache 3 x 3 + one-block 2 x 3
    # iterations on the batch's blocks; the generation's own
    gen_blocks = sum(gen["first"]["launches"].values()) // 2
    assert out["launches"]["spd_solve_batched"] == 20 * blocks + gen_blocks
    assert len(out["held_against_plain"]) >= 4
