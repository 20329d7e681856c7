"""PyTorch/CUDA port of ``oryx_tpu`` for one NVIDIA H100.

The JAX package ``oryx_tpu`` is the reference this package is held against;
nothing here imports it or JAX. Layout mirrors the reference (``api/``,
``common/``, ``ml/``, ``ops/``, ``pmml/``, ``store/``, ``models/als/``,
``models/kmeans/``, ``models/rdf/``, ``serving/``, ``transport/``, ``tools/``, ``example/``). Every entry point takes ``device=None``, which
means the CUDA card: without one it raises unless the caller passes
``device="cpu"`` (see :mod:`oryx_tpu_torch.common.device`).
"""

__version__ = "0.1.0"
