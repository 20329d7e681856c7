"""The port's device rule.

``device=None`` means the CUDA card. Without a card the call raises unless
the caller asked for the CPU explicitly (``device="cpu"``, as the tests
do): there is no silent CPU path, so a run that was meant for the card can
never report CPU numbers as if they came from it.

On the card, float32 matrix products run in full float32: TF32 keeps about
three decimal digits, which would break parity with the reference's f32
Gramians, ``YᵀY`` and serving scores. :func:`resolve` sets both PyTorch
switches off whenever it hands out a CUDA device.

:func:`to_host` is the port's one batched device-to-host fetch: several
tensors copied to the host with one synchronisation, the counterpart of
the reference's ``jax.device_get``. The static analyser's
host-device-transfer checker exempts it, as the reference's exempts
``jax.device_get``.
"""

from __future__ import annotations

import numpy as np
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


def to_host(*tensors: torch.Tensor) -> "tuple[np.ndarray, ...]":
    """The tensors as numpy arrays, with the same values and dtypes as
    ``t.cpu().numpy()`` gives each, fetched with ONE synchronisation: the
    CUDA tensors are queued as non-blocking copies on the current stream
    and the host waits once for all of them (``.cpu()`` per tensor waits
    once per tensor). CPU tensors come back as ``t.numpy()`` views, as
    ``.cpu().numpy()`` gives them."""
    out: list = [None] * len(tensors)
    pending = []
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.is_cuda:
            pending.append((i, t.to("cpu", non_blocking=True)))
        else:
            out[i] = t.numpy()
    if pending:
        for dev in dict.fromkeys(tensors[i].device for i, _ in pending):
            torch.cuda.current_stream(dev).synchronize()
        for i, host in pending:
            out[i] = host.numpy()
    return tuple(out)
