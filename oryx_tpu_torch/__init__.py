"""PyTorch/CUDA port of ``oryx_tpu`` for one NVIDIA H100.

The JAX package ``oryx_tpu`` is the reference this package is held against;
nothing here imports it or JAX. Layout mirrors the reference (``api/``,
``common/``, ``ml/``, ``ops/``, ``pmml/``, ``store/``, ``models/als/``,
``models/kmeans/``, ``models/rdf/``, ``serving/``, ``transport/``, ``tools/``, ``example/``). Every entry point takes ``device=None``, which
means the CUDA card: without one it raises unless the caller passes
``device="cpu"`` (see :mod:`oryx_tpu_torch.common.device`).
"""

__version__ = "0.1.0"

# Runtime concurrency sanitizer opt-in (ORYX_SANITIZE=locks,loop): install
# at package import, BEFORE any port module allocates its locks or spins up
# an event loop — CLI processes and test children inherit the variable and
# self-install the same way. Stdlib-only import; a no-op when the variable
# is unset, and when another sanitizer already replaced the primitives (see
# oryx_tpu_torch/tools/sanitize/__init__.py; docs/sanitizer.md).
import os as _os

if _os.environ.get("ORYX_SANITIZE"):
    from oryx_tpu_torch.tools import sanitize as _sanitize

    _sanitize.install_from_env()
