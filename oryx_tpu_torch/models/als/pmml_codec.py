"""ALS model artifact: PMML-as-pointers + X/ Y/ factor part-files.

A copy of the JAX package's ``oryx_tpu/models/als/pmml_codec.py`` (host
code, no JAX), held byte-compatible with it by
``tests/test_torch_als_update.py``: the same arrays give the same PMML text
and the same decompressed part-file text, so a model either package
publishes loads in the other. Below, "the reference" is the original Oryx
that module was modelled on.

Wire-compatible with the reference's serialization
(ALSUpdate.mfModelToPMML:430-473, saveFeaturesRDD:490-499, readFeaturesRDD):
the PMML skeleton carries Extensions X="X/", Y="Y/", features, lambda,
implicit, alpha (iff implicit), logStrength, epsilon (iff logStrength), and
full XIDs/YIDs lists as extension content; the factor matrices live beside it
as gzipped text part-files of JSON lines ``["id", [v1, ..., vk]]``.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Iterator

import numpy as np

from oryx_tpu_torch.common import ioutils
from oryx_tpu_torch.pmml import pmmlutils

PARTS = 1  # single host writes one part per matrix; readers glob part-*


def save_features(path: Path, ids: list[str], matrix: np.ndarray) -> None:
    """Write one factor matrix as gzipped JSON lines (saveFeaturesRDD:490-499)."""
    ioutils.mkdirs(path)
    with gzip.open(path / "part-00000.gz", "wt", encoding="utf-8") as f:
        for i, id_ in enumerate(ids):
            f.write(json.dumps([id_, [float(v) for v in matrix[i]]]) + "\n")


def read_features(path: Path) -> Iterator[tuple[str, np.ndarray]]:
    """Read factor part-files back (readFeaturesRDD)."""
    for part in sorted(Path(path).glob("part-*")):
        opener = gzip.open if part.suffix == ".gz" else open
        with opener(part, "rt", encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    id_, vec = json.loads(line)
                    yield str(id_), np.asarray(vec, dtype=np.float32)


def model_to_pmml(
    x: np.ndarray,
    y: np.ndarray,
    x_ids: list[str],
    y_ids: list[str],
    features: int,
    lam: float,
    alpha: float,
    implicit: bool,
    log_strength: bool,
    epsilon: float,
    candidate_path: Path,
):
    """Write X/ Y/ next to the model and return the pointer PMML
    (mfModelToPMML:430-473)."""
    candidate_path = Path(candidate_path)
    save_features(candidate_path / "X", x_ids, np.asarray(x))
    save_features(candidate_path / "Y", y_ids, np.asarray(y))
    pmml = pmmlutils.build_skeleton_pmml()
    pmmlutils.add_extension(pmml, "X", "X/")
    pmmlutils.add_extension(pmml, "Y", "Y/")
    pmmlutils.add_extension(pmml, "features", features)
    pmmlutils.add_extension(pmml, "lambda", lam)
    pmmlutils.add_extension(pmml, "implicit", str(implicit).lower())
    if implicit:
        pmmlutils.add_extension(pmml, "alpha", alpha)
    pmmlutils.add_extension(pmml, "logStrength", str(log_strength).lower())
    if log_strength:
        pmmlutils.add_extension(pmml, "epsilon", epsilon)
    pmmlutils.add_extension_content(pmml, "XIDs", x_ids)
    pmmlutils.add_extension_content(pmml, "YIDs", y_ids)
    return pmml


def pmml_to_meta(pmml) -> dict:
    """Decode the pointer PMML's hyperparameters + ID lists."""
    implicit = pmmlutils.get_extension_value(pmml, "implicit") == "true"
    log_strength = pmmlutils.get_extension_value(pmml, "logStrength") == "true"
    return {
        "x_dir": pmmlutils.get_extension_value(pmml, "X"),
        "y_dir": pmmlutils.get_extension_value(pmml, "Y"),
        "features": int(pmmlutils.get_extension_value(pmml, "features")),
        "lambda": float(pmmlutils.get_extension_value(pmml, "lambda")),
        "implicit": implicit,
        "alpha": float(pmmlutils.get_extension_value(pmml, "alpha") or 1.0),
        "logStrength": log_strength,
        "epsilon": float(pmmlutils.get_extension_value(pmml, "epsilon") or 1.0e-5),
        "x_ids": pmmlutils.get_extension_content(pmml, "XIDs") or [],
        "y_ids": pmmlutils.get_extension_content(pmml, "YIDs") or [],
    }
