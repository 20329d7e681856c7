"""The port's mesh training against its one-device runs and the reference's
sharded runs.

The four cases of ``tests/test_mesh_training.py``, restated for torch
(``jax.random`` streams cannot be reproduced in torch, so every comparison
starts both sides from the same Y₀ or centres, carried across by
:mod:`oryx_tpu_torch.state`). The reference runs on its eight-device CPU
mesh (``tests/conftest.py``); the port on a mesh of eight ``cpu`` entries,
each shard its own tensors and its own kernel calls (the plain versions on
the CPU):

* ``als_train`` with the rows sharded over ``model``: the factors come back
  as :class:`ShardedRows`, really split, padded with zero rows, and equal
  to the port's one-device train and to the reference's sharded train
  within the reference's ``rtol=2e-4, atol=2e-5``, implicit and explicit;
* the data-parallel Lloyd step (points and weights row-sharded over
  ``data``) against the unsharded one and the reference's sharded run, at
  the reference's 1e-4 / 1e-5;
* ``ALSUpdate.build_model`` through a ``ComputeContext`` with ``mesh-shape
  [1, 8]`` (``local_devices`` monkeypatched to eight ``cpu`` entries, the
  counterpart of the forced host device count) against the reference's
  ``ALSUpdate`` on its own ``[1, 8]`` mesh and the port's ``[1, 1]`` build.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from oryx_tpu.common import config as ref_cfg
from oryx_tpu.models.als import data as ref_data
from oryx_tpu.models.als import train as ref_tr
from oryx_tpu.models.kmeans import train as ref_km
from oryx_tpu.parallel.mesh import ComputeContext as RefContext
from oryx_tpu.parallel.mesh import make_mesh as ref_make_mesh
from oryx_tpu_torch import state
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.models.als.data import RatingBatch
from oryx_tpu_torch.models.kmeans import train as km
from oryx_tpu_torch.parallel import mesh as mesh_mod
from oryx_tpu_torch.parallel.mesh import ComputeContext, ShardedRows, make_mesh, shard_rows

torch.set_num_threads(1)

SHARDS = 8
RTOL, ATOL = 2e-4, 2e-5


def _rating_batch(n_users=96, n_items=64, per_user=7, seed=0):
    rng = np.random.default_rng(seed)
    agg = {}
    for u in range(n_users):
        for i in rng.choice(n_items, per_user, replace=False):
            agg[(f"u{u}", f"i{i}")] = float(rng.integers(1, 4))
    return ref_data.build_rating_batch(agg)


def _port_batch(batch):
    return RatingBatch(batch.rows, batch.cols, batch.vals, batch.users,
                       batch.items)


def _mesh(axis):
    return make_mesh(axes=(axis,), devices=["cpu"] * SHARDS)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("implicit,features,lam,iterations,seed,key", [
    (True, 8, 0.01, 3, 0, 7),
    (False, 6, 0.1, 2, 3, 11),
])
def test_als_train_sharded_matches_single_device_and_the_reference(
        implicit, features, lam, iterations, seed, key):
    """The reference's two sharded-vs-single cases, on both packages from
    the reference's own Y₀."""
    batch = _rating_batch(seed=seed)
    n_users, n_items = len(batch.users), len(batch.items)
    rkey = jax.random.PRNGKey(key)
    ref_kwargs = dict(features=features, lam=lam, alpha=1.0,
                      implicit=implicit, iterations=iterations, key=rkey,
                      chunk=128)
    rx, ry = ref_tr.als_train(batch, mesh=ref_make_mesh(axes=("model",)),
                              row_axis="model", **ref_kwargs)
    y0 = state.init_y(ref_tr._init_factors(n_items, n_items, features, rkey),
                      device="cpu")
    kwargs = dict(iterations=iterations, init_y=y0, chunk=128, device="cpu")
    x1, y1 = tr.als_train(_port_batch(batch), features, lam, 1.0, implicit,
                          **kwargs)
    mesh = _mesh("model")
    timings: dict = {}
    x2, y2 = tr.als_train(_port_batch(batch), features, lam, 1.0, implicit,
                          mesh=mesh, row_axis="model", timings=timings,
                          **kwargs)
    assert timings["shards"] == SHARDS
    for arr, n, ref in ((x2, n_users, rx), (y2, n_items, ry)):
        # row-partitioned over the mesh, padded to the block boundary
        assert isinstance(arr, ShardedRows) and arr.axis == "model"
        assert arr.n_shards == SHARDS and arr.shape == ref.shape
        assert all(s.shape[0] < arr.shape[0] for s in arr.shards)
        full = arr.full()
        assert not full[n:].any()  # padding rows are zero
        _close(full, np.asarray(ref))
    _close(x2.full()[:n_users], x1)
    _close(y2.full()[:n_items], y1)


def test_als_train_sharded_checkpoints_and_resumes(tmp_path):
    """Checkpoints on the mesh path: a run killed after step 2 of 4 redoes
    only the last two iterations and lands on the uninterrupted run's
    factors; a fully trained checkpoint comes back padded and
    row-sharded with no solve (the reference's zero-redo resume)."""
    import os

    from oryx_tpu_torch.common import checkpoint as ckpt

    batch = _port_batch(_rating_batch(seed=5))
    kwargs = dict(iterations=4, chunk=128, device="cpu", mesh=_mesh("model"),
                  row_axis="model")

    def train(cp, timings):
        return tr.als_train(batch, 4, 0.05, 1.0, True, checkpointer=cp,
                            generator=torch.Generator().manual_seed(2),
                            timings=timings, **kwargs)

    store = ckpt.CheckpointStore(tmp_path, keep=4)
    fp = "f" * 16
    x, y = train(ckpt.TrainerCheckpointer(store, fp, interval=2), {})
    assert store.steps(fp) == [2, 4]
    for _, step, path in store.entries():
        if step == 4:
            os.unlink(path)
    resumed: dict = {}
    x2, y2 = train(ckpt.TrainerCheckpointer(store, fp, interval=2), resumed)
    assert resumed["ckpt_resumed_from"] == 2 and len(resumed["iter_s"]) == 2
    for got, want in ((x2, x), (y2, y)):
        np.testing.assert_allclose(got.full().numpy(), want.full().numpy(),
                                   rtol=1e-5, atol=1e-5)
    done: dict = {}
    x3, y3 = train(ckpt.TrainerCheckpointer(store, fp, interval=2), done)
    assert done["ckpt_resumed_from"] == 4 and done["iter_s"] == []
    for got, want in ((x3, x2), (y3, y2)):
        assert isinstance(got, ShardedRows) and got.shape == want.shape
        assert got.n_shards == SHARDS
        assert torch.equal(got.full(), want.full())


def test_kmeans_dp_step_sharded_matches():
    """The data-parallel Lloyd step: points and weights sharded over
    ``data``, each shard's sweep on its device, sums and counts added over
    the shards; against the unsharded step and the reference's sharded
    run, from the reference's own starting centres."""
    rng = np.random.default_rng(4)
    pts_np = rng.standard_normal((512, 12)).astype(np.float32)
    w_np = np.ones(512, dtype=np.float32)
    key = jax.random.PRNGKey(5)
    ref_mesh = ref_make_mesh(axes=("data",))
    c_ref, n_ref, cost_ref = ref_km._kmeans_single_run(
        key, jax.device_put(pts_np, NamedSharding(ref_mesh, P("data", None))),
        jax.device_put(w_np, NamedSharding(ref_mesh, P("data"))), 5, 4,
        ref_km.INIT_RANDOM)
    c0 = state.kmeans_centers(ref_km._init_centers(
        key, jnp.asarray(pts_np), 5, ref_km.INIT_RANDOM), device="cpu")
    pts, w = torch.from_numpy(pts_np), torch.from_numpy(w_np)
    c1, n1, cost1 = km._lloyd_run(pts, w, c0, 4)
    mesh = _mesh("data")
    sp, sw = shard_rows(pts, mesh, "data"), shard_rows(w, mesh, "data")
    assert sp.n_shards == SHARDS and sp.rows_per_shard == 512 // SHARDS
    c2, n2, cost2 = km._lloyd_run(sp, sw, c0, 4)
    for c, n, cost in ((c1, n1, cost1), (c_ref, n_ref, cost_ref)):
        np.testing.assert_allclose(np.asarray(c), c2.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(n), n2.numpy(), rtol=1e-5)
        assert float(cost) == pytest.approx(float(cost2), rel=1e-4)


def test_als_update_build_model_on_mesh(tmp_path, monkeypatch):
    """``ALSUpdate.build_model`` through a ``ComputeContext`` with
    ``mesh-shape [1, 8]``: the factors shard over ``model`` and equal the
    reference's ``[1, 8]`` build and the port's ``[1, 1]`` one."""
    from oryx_tpu.api.keymessage import KeyMessage as RefKeyMessage
    from oryx_tpu.models.als import pmml_codec as ref_codec
    from oryx_tpu.models.als.update import ALSUpdate as RefUpdate
    from oryx_tpu_torch.api.keymessage import KeyMessage
    from oryx_tpu_torch.models.als import pmml_codec
    from oryx_tpu_torch.models.als.update import ALSUpdate
    from test_torch_als_update import _inject_y0, _read

    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda platform=None: [torch.device("cpu")] * SHARDS)
    rng = np.random.default_rng(9)
    lines = [f"u{u},i{i},1,{u * 50 + int(i)}"
             for u in range(50) for i in rng.choice(40, 6, replace=False)]
    base = {"oryx.als.iterations": 3, "oryx.als.hyperparams.features": 5,
            "oryx.batch.streaming.config.platform": "cpu",
            "oryx.batch.streaming.config.mesh-axes": ["data", "model"]}

    def conf(module, shape):
        return module.overlay_on(
            {**base, "oryx.batch.streaming.config.mesh-shape": shape},
            module.get_default())

    _inject_y0(monkeypatch, 5, 5)
    params = [5, 0.001, 1.0]
    built = {}
    for name, shape in (("sharded", [1, SHARDS]), ("single", [1, 1])):
        context = ComputeContext(conf(cfg, shape), tier="batch")
        assert context.mesh.shape == {"data": 1, "model": shape[1]}
        assert context.num_devices == shape[1]
        # the counterparts of the reference's sharding() / replicated()
        rows = context.shard_rows(torch.arange(10.0)[:, None], "model")
        assert rows.n_shards == shape[1] and rows.shape[0] % shape[1] == 0
        assert torch.equal(rows.full()[:10, 0], torch.arange(10.0))
        assert not rows.full()[10:].any()
        assert len(context.replicated(torch.ones(3))) == shape[1]
        update = ALSUpdate(conf(cfg, shape), device="cpu")
        assert update.build_model(context, [KeyMessage(None, ln) for ln in lines],
                                  params, tmp_path / name) is not None
        built[name] = {side: _read(pmml_codec, tmp_path / name / side)
                       for side in ("X", "Y")}
        record = update.candidate_record(tmp_path / name)
        assert record.get("shards") == (SHARDS if name == "sharded" else None)
    ref_context = RefContext(conf(ref_cfg, [1, SHARDS]), tier="batch")
    assert ref_context.mesh.shape["model"] == SHARDS
    assert RefUpdate(conf(ref_cfg, [1, SHARDS])).build_model(
        ref_context, [RefKeyMessage(None, ln) for ln in lines], params,
        tmp_path / "ref") is not None
    for side in ("X", "Y"):
        ids, got = built["sharded"][side]
        ref_ids, want = _read(ref_codec, tmp_path / "ref" / side)
        single_ids, single = built["single"][side]
        assert ids == ref_ids == single_ids
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got, single, rtol=2e-3, atol=2e-4)


def test_smoke_mesh_phase_at_a_small_size(monkeypatch):
    """``chip_smoke.mesh_phase``'s ALS, k-means and serving parts on the
    CPU at a small size, every check as strict as on the card: the plain
    versions stand in for the kernels, each call counted at its shape as
    the wrappers count launches; the card-only calls stand in as no-ops.
    Its config and bootstrap parts need the card (``mesh_config`` checks
    the one card, ``mesh_bootstrap`` joins an ``nccl`` group)."""
    import chip_smoke as cs
    from oryx_tpu_torch.models.als import data as als_data
    from oryx_tpu_torch.ops import kernels as K

    cpu = torch.device("cpu")
    for mod in (cs, tr):
        monkeypatch.setattr(mod, "resolve", lambda device=None: cpu)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.5)[1])
    monkeypatch.setattr(tr, "_resolve_paths", lambda *a: (True, True))
    gg, spd, sweep = (tr.gather_gramian_accumulate, tr.spd_solve_batched,
                      K.kmeans_assign_accumulate)

    def counted_gg(*args, **kwargs):
        K._count("gather_gramian_accumulate", cs.gg_key(args, kwargs))
        return gg(*args, **kwargs)

    def counted_spd(a, b):
        K._count("spd_solve_batched", tuple(b.shape),
                 "spd_solve_batched." + K.spd_variant(b.shape[1]))
        return spd(a, b)

    def counted_sweep(points, weights, centers):
        K._count("kmeans_assign_accumulate", cs.sweep_key((points, weights, centers), {}))
        return sweep(points, weights, centers)

    monkeypatch.setattr(tr, "gather_gramian_accumulate", counted_gg)
    monkeypatch.setattr(tr, "spd_solve_batched", counted_spd)
    monkeypatch.setattr(K, "kmeans_assign_accumulate", counted_sweep)
    for name, value in dict(N_USERS=20_000, N_ITEMS=1_000, NNZ=60_000,
                            FEATURES=8, KM_K=16, FLAGSHIP_ITEMS=20_000,
                            MESH_BATCH=16).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "mesh_config", lambda dev: {})
    monkeypatch.setattr(cs, "mesh_bootstrap", lambda dev: {})
    lines = cs.synthetic_lines(np.random.default_rng(cs.SEED))
    batch = als_data.prepare(lines, implicit=True)
    t0 = __import__("time").perf_counter()
    x, y = tr.als_train(batch, 8, cs.LAM, cs.ALPHA, True, cs.ITERATIONS,
                        generator=torch.Generator().manual_seed(cs.SEED + 1),
                        device="cpu")
    train_s = __import__("time").perf_counter() - t0
    points = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4000, 8), dtype=np.float32))
    out = cs.mesh_phase(batch, x, y, train_s, points, np.random.default_rng(3))
    als, km = out["als"], out["kmeans"]
    blocks = als["blocks"]
    assert blocks["user"] % cs.MESH_SHARDS == 0 and blocks["item"] % cs.MESH_SHARDS == 0
    assert als["launches"]["gather_gramian_accumulate"] == cs.ITERATIONS * (
        blocks["user"] + blocks["item"])
    assert als["vs_unsharded"]["x"]["max_excess"] <= 0.0
    assert km["shard_launches"] == [cs.KM_ITERATIONS + 1] * cs.MESH_SHARDS
    assert len(km["lockstep"]) == cs.KM_ITERATIONS + 1
    assert set(out["serving"]) >= {"plain", "lsh_0.3"}
    held = out["held_against_plain"]
    assert {h["kernel"] for h in held} == {
        "gather_gramian_accumulate", "spd_solve_batched", "kmeans_assign_accumulate"}
