"""Vector/matrix math on tensors: dot, norm, cosine similarity, Gramian.

The port of the reference's ``ops/vectormath`` (VectorMath.java:38-110 in
the original Oryx). Tensor inputs stay on their device; other inputs (numpy,
lists) go to ``device`` under the port's device rule. Float32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from oryx_tpu_torch.common.device import as_tensor


def dot(x, y, device=None) -> torch.Tensor:
    """Dot product (VectorMath.dot)."""
    return torch.dot(as_tensor(x, device, torch.float32),
                     as_tensor(y, device, torch.float32))


def norm(x, device=None) -> torch.Tensor:
    """L2 norm (VectorMath.norm)."""
    return torch.linalg.vector_norm(as_tensor(x, device, torch.float32))


def cosine_similarity(x, y, norm_y=None, device=None) -> torch.Tensor:
    """Cosine similarity; optionally with a precomputed ||y||
    (VectorMath.cosineSimilarity)."""
    x = as_tensor(x, device, torch.float32)
    y = as_tensor(y, device, torch.float32)
    ny = torch.linalg.vector_norm(y) if norm_y is None else norm_y
    return torch.dot(x, y) / (torch.linalg.vector_norm(x) * ny)


def cosine_similarities(rows, y, norm_y=None, device=None) -> np.ndarray:
    """Cosine similarity of every row of ``rows`` against ``y`` in one
    product on ``device``, returned as a host float32 array (the batched
    form of :func:`cosine_similarity` for the similarity and because
    endpoints: one product and one transfer for the whole list)."""
    rows = as_tensor(np.asarray(rows, dtype=np.float32), device)
    y = as_tensor(np.asarray(y, dtype=np.float32), device)
    ny = torch.linalg.vector_norm(y) if norm_y is None else norm_y
    sims = (rows @ y) / (torch.linalg.vector_norm(rows, dim=1) * ny)
    return sims.cpu().numpy()


def transpose_times_self(rows, device=None) -> "torch.Tensor | None":
    """Gramian XᵀX of a collection/array of row vectors
    (VectorMath.transposeTimesSelf); None for empty input, as the reference
    returns null."""
    if rows is None:
        return None
    if not isinstance(rows, torch.Tensor):
        rows = np.asarray(
            rows if hasattr(rows, "shape") else list(rows), dtype=np.float32)
        if rows.size == 0:
            return None
    elif rows.numel() == 0:
        return None
    x = as_tensor(rows, device, torch.float32)
    if x.ndim == 1:
        x = x[None, :]
    return x.T @ x
