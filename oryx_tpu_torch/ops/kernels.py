"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version.

* :func:`gather_gramian_accumulate` (``csrc/gather_gramian.cu``) replaces
  the reference's Pallas ``_make_gather_gramian_kernel``
  (``oryx_tpu/ops/pallas_kernels.py:221-289``);
* :func:`spd_solve_batched` (``csrc/spd_solve.cu``) replaces
  ``_spd_solve_kernel`` (``pallas_kernels.py:89-116``);
* :func:`kmeans_assign_accumulate` (``csrc/kmeans_assign.cu``), one Lloyd
  sweep of k-means, replaces ``_kernel`` (``pallas_kernels.py:357-388``).

Dispatch is by the tensors' device and nothing else: a CPU tensor goes to
the plain version (that is how the CPU tests run the trainer); a CUDA
tensor goes to the kernel, or the wrapper raises. Nothing falls back from a
failed kernel to the plain version. Each kernel launch adds one to its
entry in :data:`LAUNCHES`, so a run can show that it went through the
kernels; the plain versions count nothing.

Kernels launch on PyTorch's current stream and allocate nothing: the
wrappers allocate the outputs. They are built on first use
(:mod:`oryx_tpu_torch.ops._build`).
"""

from __future__ import annotations

import ctypes
import logging

import torch

from oryx_tpu_torch.ops import _build

log = logging.getLogger(__name__)

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"gather_gramian_accumulate": 0, "spd_solve_batched": 0,
            "kmeans_assign_accumulate": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# The reference's gate (pallas_kernels._GG_MAX_FEATURES), kept as it is: the
# CUDA kernel tiles any k, so the trainer selects the fused path exactly
# where the reference does.
GG_MAX_FEATURES = 256

# Shared memory one block may use on an H100 (227 KB). The SPD kernel keeps
# the augmented k x (k+1) matrix plus one k-vector there, 4·k·(k+2) bytes:
# k <= 240 fits. Past that the solve is a Cholesky factorisation.
SPD_SMEM_BYTES = 232_448

_C_INT = ctypes.c_int
_C_PTR = ctypes.c_void_p
_SIGNATURES = {
    "oryx_gather_gramian": (
        [_C_PTR, _C_INT, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR,
         _C_PTR, _C_INT, _C_INT, _C_INT, _C_PTR],
        _C_INT,
    ),
    "oryx_spd_solve": ([_C_PTR, _C_PTR, _C_PTR, _C_INT, _C_INT, _C_PTR], _C_INT),
    "oryx_kmeans_assign": (
        [_C_PTR, _C_PTR, _C_PTR, _C_INT, _C_INT, _C_INT, _C_INT, _C_PTR,
         _C_PTR, _C_PTR, _C_PTR, _C_PTR],
        _C_INT,
    ),
}
_cholesky_logged: set = set()


def _entry(lib_name: str, fn_name: str):
    fn = getattr(_build.library(lib_name), fn_name)
    fn.argtypes, fn.restype = _SIGNATURES[fn_name]
    return fn


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for arg, (t, dtypes) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected one "
                            f"of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _route(name: str, dev: torch.device) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); any other device raises."""
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


# -- gather-Gramian -----------------------------------------------------------


def gather_gramian_supported(features: int) -> bool:
    """Whether the trainer's fused path takes the gather-Gramian kernel."""
    return features <= GG_MAX_FEATURES


def gather_gramian_accumulate(y, srow, scols, w, coef, slens, *, block: int):
    """Fused gather → per-slot Gramian → per-row accumulate for one block.

    Args:
      y: (R, k) opposite-side factors, float32 or bfloat16.
      srow: (S,) int32 block-local owner row per slot, sorted ascending,
        pad = ``block`` (the spill row).
      scols: (S, T) int32 row indices into ``y``.
      w / coef: (S, T) float32 per-entry Gramian / RHS weights, zero on
        padding entries.
      slens: (S,) int32 valid entries per slot (0 = pad slot).
      block: rows per block; the outputs carry the extra spill row.

    Returns (A (block+1, k, k), b (block+1, k)), float32. Rows no slot
    visits are exactly zero.
    """
    name = "gather_gramian_accumulate"
    if not _route(name, y.device):
        return gather_gramian_accumulate_plain(
            y, srow, scols, w, coef, slens, block=block)
    dev = y.device
    i32, f32 = (torch.int32,), (torch.float32,)
    _check_cuda(name, dev, y=(y, (torch.float32, torch.bfloat16)),
                srow=(srow, i32), scols=(scols, i32), w=(w, f32),
                coef=(coef, f32), slens=(slens, i32))
    s, t = scols.shape
    k = y.shape[1]
    if srow.shape != (s,) or slens.shape != (s,) or w.shape != (s, t) \
            or coef.shape != (s, t):
        raise ValueError(f"{name}: inconsistent slot shapes")
    # slots are row-sorted, so row r owns slots [start[r], start[r+1])
    row_start = torch.searchsorted(
        srow, torch.arange(block + 2, device=dev, dtype=torch.int32),
        out_int32=True,
    )
    a = torch.empty((block + 1, k, k), device=dev, dtype=torch.float32)
    b = torch.empty((block + 1, k), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = _entry("gather_gramian", "oryx_gather_gramian")(
            y.data_ptr(), int(y.dtype == torch.bfloat16), row_start.data_ptr(),
            scols.data_ptr(), w.data_ptr(), coef.data_ptr(), slens.data_ptr(),
            a.data_ptr(), b.data_ptr(), block + 1, t, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return a, b


def gather_gramian_accumulate_plain(y, srow, scols, w, coef, slens, *,
                                    block: int):
    """Plain PyTorch version of :func:`gather_gramian_accumulate`: gather,
    per-slot einsum, and ``index_add_`` into the owner rows. Same roundings
    (weights cast to y's type, float32 products and sums); other summation
    order. ``slens`` is implied by the zero weights on padding entries."""
    k = y.shape[1]
    ga, gb = slot_gramians(y, scols, w, coef)
    idx = srow.long()
    a = torch.zeros((block + 1, k, k), device=y.device, dtype=torch.float32)
    b = torch.zeros((block + 1, k), device=y.device, dtype=torch.float32)
    return a.index_add_(0, idx, ga), b.index_add_(0, idx, gb)


def slot_gramians(y, scols, w, coef):
    """Per-slot Gramians (S, k, k) and right-hand sides (S, k): the gathered
    factor rows contracted over the slot width, with the weights cast to
    y's type and float32 products and sums."""
    yg = y[scols.long()].float()  # (S, T, k)
    ga = torch.einsum("st,sti,stj->sij", w.to(y.dtype).float(), yg, yg)
    gb = torch.einsum("st,sti->si", coef.to(y.dtype).float(), yg)
    return ga, gb


# -- SPD solve ----------------------------------------------------------------


def spd_use_kernel(k: int) -> bool:
    """Whether a k-feature system fits the SPD kernel's shared memory
    (k <= 240 on an H100); larger k is solved by Cholesky."""
    return 4 * k * (k + 2) <= SPD_SMEM_BYTES


def spd_solve_batched(a, b):
    """Solve ``a[i] @ x[i] = b[i]`` for a batch of regularised SPD systems.

    Args: a (B, k, k) float32, b (B, k) float32. Returns x (B, k) float32.
    Gauss-Jordan without pivoting (the reference kernel's algorithm) for
    ``spd_use_kernel(k)``; a Cholesky solve past that gate, on any device.
    """
    name = "spd_solve_batched"
    n, k = b.shape
    if not spd_use_kernel(k):
        if k not in _cholesky_logged:
            _cholesky_logged.add(k)
            log.info("spd_solve_batched: k=%d exceeds the kernel's shared "
                     "memory; using a Cholesky solve", k)
        return spd_solve_cholesky(a, b)
    if not _route(name, b.device):
        return spd_solve_batched_plain(a, b)
    dev = b.device
    f32 = (torch.float32,)
    _check_cuda(name, dev, a=(a, f32), b=(b, f32))
    if a.shape != (n, k, k):
        raise ValueError(f"{name}: a has shape {tuple(a.shape)}, expected "
                         f"{(n, k, k)}")
    x = torch.empty((n, k), device=dev, dtype=torch.float32)
    if n == 0:
        return x
    with torch.cuda.device(dev):
        err = _entry("spd_solve", "oryx_spd_solve")(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return x


def spd_solve_batched_plain(a, b):
    """Plain PyTorch version of the SPD kernel: the same Gauss-Jordan steps
    in the same order, over the whole batch at once."""
    k = b.shape[-1]
    aug = torch.cat([a.float(), b.float()[..., None]], dim=-1)
    rows = torch.arange(k, device=aug.device)
    for j in range(k):
        piv_row = aug[:, j:j + 1, :] / aug[:, j:j + 1, j:j + 1]
        # subtracting (fac − e_j) ⊗ piv_row eliminates column j from every
        # row and leaves row j as the normalised pivot row
        fac = aug[:, :, j:j + 1] - (rows == j).float()[None, :, None]
        aug = aug - fac * piv_row
    return aug[:, :, k]


def spd_solve_cholesky(a, b):
    """The reference's fallback semantics: Cholesky factor and solve."""
    chol, _ = torch.linalg.cholesky_ex(a.float())
    return torch.cholesky_solve(b.float()[..., None], chol)[..., 0]


# -- k-means Lloyd sweep --------------------------------------------------------

# The sweep kernel's partial sums: at most this many per-CTA slabs, at least
# 256 points each, and a workspace of at most 2^26 floats (256 MB). The count
# depends on N, K and D only, so the summation order is the same on every card.
KMEANS_MAX_PARTS = 1024
KMEANS_POINTS_PER_PART = 256
KMEANS_WORKSPACE_FLOATS = 1 << 26


def kmeans_parts(n: int, k: int, d: int) -> int:
    """Number of partial slabs the sweep kernel reduces for (N, K, D)."""
    slab = k * d + k + 1
    return max(1, min(-(-n // KMEANS_POINTS_PER_PART), KMEANS_MAX_PARTS,
                      KMEANS_WORKSPACE_FLOATS // slab))


def kmeans_assign_accumulate(points, weights, centers):
    """One Lloyd sweep: assign each point to its nearest centre and
    accumulate per centre.

    Args: points (N, D), weights (N,) (0 = the point contributes nothing),
    centers (K, D), all float32. Returns (sums (K, D), counts (K,), cost ())
    float32: the weighted sums and weights of the points nearest each centre,
    and the weighted sum of their squared distances. Distances are
    ``max(|p|² − 2·p·c + |c|², 0)``; ties go to the lowest centre index.
    """
    name = "kmeans_assign_accumulate"
    if not _route(name, points.device):
        return kmeans_assign_accumulate_plain(points, weights, centers)
    dev = points.device
    f32 = (torch.float32,)
    _check_cuda(name, dev, points=(points, f32), weights=(weights, f32),
                centers=(centers, f32))
    n, d = points.shape
    k = centers.shape[0]
    if weights.shape != (n,) or centers.shape != (k, d) or k == 0 or d == 0:
        raise ValueError(f"{name}: points {tuple(points.shape)}, weights "
                         f"{tuple(weights.shape)}, centers "
                         f"{tuple(centers.shape)} do not fit together")
    slab = k * d + k + 1
    if n == 0:
        out = torch.zeros(slab, device=dev, dtype=torch.float32)
    else:
        parts = kmeans_parts(n, k, d)
        assign = torch.empty(n, device=dev, dtype=torch.int32)
        min_d2 = torch.empty(n, device=dev, dtype=torch.float32)
        ws = torch.empty((parts, slab), device=dev, dtype=torch.float32)
        out = torch.empty(slab, device=dev, dtype=torch.float32)
        with torch.cuda.device(dev):
            err = _entry("kmeans_assign", "oryx_kmeans_assign")(
                points.data_ptr(), weights.data_ptr(), centers.data_ptr(),
                n, d, k, parts, assign.data_ptr(), min_d2.data_ptr(),
                ws.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(name, err)
        LAUNCHES[name] += 1
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[-1]


def kmeans_assign_accumulate_plain(points, weights, centers):
    """Plain PyTorch version of :func:`kmeans_assign_accumulate`: the same
    expansion, clamp and first-index argmin; the sums as a one-hot matrix
    product. Other summation orders."""
    d2 = ((points * points).sum(dim=1, keepdim=True)
          - 2.0 * (points @ centers.T)
          + (centers * centers).sum(dim=1)[None, :]).clamp_min(0.0)
    nearest = d2.argmin(dim=1)
    min_d2 = d2.gather(1, nearest[:, None])[:, 0]
    indicator = (torch.nn.functional.one_hot(nearest, centers.shape[0])
                 .to(points.dtype) * weights[:, None])
    return indicator.T @ points, indicator.sum(dim=0), (min_d2 * weights).sum()
