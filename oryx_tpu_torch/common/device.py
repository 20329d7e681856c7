"""The port's device rule.

``device=None`` means the CUDA card. Without a card the call raises unless
the caller asked for the CPU explicitly (``device="cpu"``, as the tests
do): there is no silent CPU path, so a run that was meant for the card can
never report CPU numbers as if they came from it.

On the card, float32 matrix products run in full float32: TF32 keeps about
three decimal digits, which would break parity with the reference's f32
Gramians, ``YᵀY`` and serving scores. :func:`resolve` sets both PyTorch
switches off whenever it hands out a CUDA device.
"""

from __future__ import annotations

import torch


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """The torch device an entry point runs on (see the module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_tensor(x, device: "str | torch.device | None" = None,
              dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its own device (only ``dtype`` is
    applied); anything else (numpy, lists) is placed on :func:`resolve`'s
    device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve(device))
