"""The main path's own reference suites as the port runs them.

``tests/test_als.py``, ``tests/test_kmeans.py`` and
``tests/test_als_quality.py`` run their own source against the port
through :mod:`tests.torch_mirror`, on the CPU in the tier-1 suite
(``tests/test_torch_als.py``, ``tests/test_torch_kmeans_suite.py``,
``tests/test_torch_als_quality.py``) and on the card
(``tests/test_torch_cuda_suites.py``). Both load them here, with the same
patches; only the module global ``DEVICE`` differs.

Every patch is the port's device rule. A port entry point's
``device=None`` is the CUDA card, with no silent CPU path, so each call
that trains or serves names ``device=DEVICE``; and a tensor the port left
on that device is fetched (``.cpu()``) where the body hands it to numpy,
as ``np.asarray`` fetches a JAX array. No assertion, bound or tolerance
is touched, and each patch must match its text exactly once.

On the card one more patch swaps the suite conftest's ``LenOnlyIDs``
(that conftest imports JAX) for its copy in :mod:`tests.torch_mirror`.

The new suite files import their helpers as top-level modules
(``import torch_mirror``), from the ``tests`` directory that pytest puts
on the path: on a machine where another installed package is named
``tests``, ``from tests import ...`` would find that one.
"""

from __future__ import annotations

import torch_mirror

ALS = "test_als.py"
KMEANS = "test_kmeans.py"
QUALITY = "test_als_quality.py"

#: reference ids that no mirror runs, each with its reason
LEFT_OUT = {
    ALS: {
        "test_batched_foldin_speedup_10k":
            "a wall-clock gate on host numpy code: the port's "
            "models/als/foldin.py and ops/solver.py are the reference's "
            "(pinned by tests/test_torch_als.py), so the reference's own gate "
            "already times this code; it waits with the other wall-clock "
            "gates (ROADMAP Queue 1, item 8f)",
    },
    KMEANS: {},
    QUALITY: {},
}

_FETCHED_SLABS = (
    "            np.testing.assert_array_equal(np.asarray(a.srows), np.asarray(b.srows))\n"
    "            np.testing.assert_array_equal(np.asarray(a.scols), np.asarray(b.scols))\n"
    "            np.testing.assert_array_equal(np.asarray(a.svals), np.asarray(b.svals))\n"
    "            np.testing.assert_array_equal(np.asarray(a.slens), np.asarray(b.slens))\n"
)

PATCHES = {
    ALS: [
        # the trainer (test_als_train_implicit_auc, _explicit_rmse,
        # _publish_model)
        ("iterations=5, chunk=512)", "iterations=5, chunk=512, device=DEVICE)"),
        ("iterations=6, chunk=512)", "iterations=6, chunk=512, device=DEVICE)"),
        ("iterations=3, chunk=256)", "iterations=3, chunk=256, device=DEVICE)"),
        ("np.asarray(x), np.asarray(y), batch.users",
         "np.asarray(x.cpu()), np.asarray(y.cpu()), batch.users"),
        # the serving model
        ("ALSServingModel(k, True, sample_rate)",
         "ALSServingModel(k, True, sample_rate, device=DEVICE)"),
        ("ALSServingModel(16, True, 0.5)",
         "ALSServingModel(16, True, 0.5, device=DEVICE)"),
        ("ALSServingModel(4, True)", "ALSServingModel(4, True, device=DEVICE)"),
        ("m.y.materialize()", "m.y.materialize(device=DEVICE)"),
        ("np.asarray(mat) @ q", "np.asarray(mat.cpu()) @ q"),
        # the serving manager
        ("ALSServingModelManager(config)\n    lines, batch",
         "ALSServingModelManager(config, device=DEVICE)\n    lines, batch"),
        ("ALSServingModelManager(config)\n    _publish_model([mgr], tmp_path)\n"
         "    model1",
         "ALSServingModelManager(config, device=DEVICE)\n"
         "    _publish_model([mgr], tmp_path)\n    model1"),
        # the blocked pack
        ("tr.prepare_blocked(batch, 16, workers=1)",
         "tr.prepare_blocked(batch, 16, workers=1, device=DEVICE)"),
        ("tr.prepare_blocked(batch, 16, workers=8)",
         "tr.prepare_blocked(batch, 16, workers=8, device=DEVICE)"),
        (_FETCHED_SLABS, _FETCHED_SLABS.replace(".srows)", ".srows.cpu())")
         .replace(".scols)", ".scols.cpu())").replace(".svals)", ".svals.cpu())")
         .replace(".slens)", ".slens.cpu())")),
        # the batch updater
        ("ALSUpdate(config)", "ALSUpdate(config, device=DEVICE)"),
    ],
    KMEANS: [
        ("    centers, counts = kmtrain.kmeans_train(pts, 3, iterations=15, runs=2)",
         "    centers, counts = kmtrain.kmeans_train(pts, 3, iterations=15, runs=2, "
         "device=DEVICE)"),
        ("kmtrain.kmeans_train(pts, 5, init=kmtrain.INIT_RANDOM)",
         "kmtrain.kmeans_train(pts, 5, init=kmtrain.INIT_RANDOM, device=DEVICE)"),
        ("good_centers, good_counts = kmtrain.kmeans_train(pts, 3, iterations=15, runs=2)",
         "good_centers, good_counts = kmtrain.kmeans_train(pts, 3, iterations=15, "
         "runs=2, device=DEVICE)"),
        ("KMeansUpdate(config)\n    data = [",
         "KMeansUpdate(config, device=DEVICE)\n    data = ["),
        ("KMeansUpdate(config)\n\n    sent = []",
         "KMeansUpdate(config, device=DEVICE)\n\n    sent = []"),
    ],
    QUALITY: [
        ("ALSUpdate(config)\n    lines = _synthetic_movielens()",
         "ALSUpdate(config, device=DEVICE)\n    lines = _synthetic_movielens()"),
        ("ALSUpdate(config)\n    data = [KeyMessage(None, ln) for ln in lines]",
         "ALSUpdate(config, device=DEVICE)\n"
         "    data = [KeyMessage(None, ln) for ln in lines]"),
    ],
}

#: patches for a run on the card only
CARD_PATCHES = {
    ALS: [("from conftest import LenOnlyIDs",
           "from torch_mirror import LenOnlyIDs")],
    KMEANS: [],
    QUALITY: [],
}


def patches(ref_test: str, device: str) -> list:
    """The patches of ``tests/<ref_test>`` for a run on ``device``."""
    card = [] if device == "cpu" else CARD_PATCHES[ref_test]
    return PATCHES[ref_test] + card


def load(ref_test: str, device: str):
    """``tests/<ref_test>`` loaded with its patches, its global ``DEVICE``
    (read by the patched calls when a body runs) set to ``device``."""
    module = torch_mirror.load(ref_test, patches(ref_test, device))
    module.DEVICE = device
    return module


def collectable(module, ref_test: str) -> dict:
    """:func:`tests.torch_mirror.collectable` without the ids
    :data:`LEFT_OUT` names."""
    return {name: value
            for name, value in torch_mirror.collectable(module).items()
            if name not in LEFT_OUT[ref_test]}
