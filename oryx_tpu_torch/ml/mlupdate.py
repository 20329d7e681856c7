"""Reading a model off the update topic.

Only ``read_pmml_from_update_key_message`` of the JAX package's
``oryx_tpu/ml/mlupdate.py`` (AppPMMLUtils.readPMMLFromUpdateKeyMessage:
234-259 in the original Oryx): the speed and serving managers decode
``MODEL`` (inline PMML) and ``MODEL-REF`` (a path) with it. The batch
harness around it (candidates, model store, publish) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

from oryx_tpu_torch.pmml import pmmlutils


class MissingModelError(Exception):
    """A ``MODEL-REF`` message names a path that does not exist."""


def read_pmml_from_update_key_message(key: str, message: str):
    """Decode MODEL / MODEL-REF update messages into a PMML Element."""
    if key == "MODEL":
        return pmmlutils.from_string(message)
    if key == "MODEL-REF":
        path = Path(message)
        if not path.exists():
            raise MissingModelError(f"MODEL-REF path does not exist: {message}")
        return pmmlutils.read(path)
    raise ValueError(f"not a model message: {key}")
