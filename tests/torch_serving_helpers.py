"""The port's counterparts of ``tests/test_serving.py``'s model helpers.

:func:`_train_tiny` and :func:`_publish_to_topic` take the reference's
arguments and return what the reference's return, built with the port:
the same 25 x 15 interactions, trained by the port's ALS on the CPU,
written by the port's codec, sent through the port's producer. Mirrored
reference files (:mod:`tests.torch_mirror`) import them in place of the
reference's.
"""

from __future__ import annotations

import json

import numpy as np

from oryx_tpu_torch.models.als import data as d
from oryx_tpu_torch.models.als import pmml_codec
from oryx_tpu_torch.models.als import train as tr
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.transport import topic as tp


def _train_tiny(tmp_path):
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((25, 3)) @ rng.standard_normal((3, 15))
    lines = []
    for u in range(25):
        for i in np.argsort(-scores[u])[:5]:
            lines.append(f"u{u},i{i},1,{u * 100 + int(i)}")
    batch = d.prepare(lines, implicit=True)
    x, y = tr.als_train(batch, features=4, lam=0.001, alpha=1.0, implicit=True,
                        iterations=3, chunk=256, device="cpu")
    pmml = pmml_codec.model_to_pmml(
        x.numpy(), y.numpy(), batch.users.index_to_id, batch.items.index_to_id,
        4, 0.001, 1.0, True, False, 1e-5, tmp_path,
    )
    known = {}
    for it in d.parse_lines(lines):
        known.setdefault(it.user, []).append(it.item)
    return pmml, batch, known


def _publish_to_topic(pmml, tmp_path, known, broker_url="memory:"):
    prod = tp.TopicProducerImpl(broker_url, "OryxUpdate")
    prod.send("MODEL", pmmlutils.to_string(pmml))
    for id_, vec in pmml_codec.read_features(tmp_path / "Y"):
        prod.send("UP", json.dumps(["Y", id_, [float(v) for v in vec]]))
    for id_, vec in pmml_codec.read_features(tmp_path / "X"):
        prod.send("UP", json.dumps(["X", id_, [float(v) for v in vec],
                                    known.get(id_, [])]))
