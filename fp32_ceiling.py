"""The CUDA cores' reachable FP32 rate beside the k-means sweep's assign launch.

    python3 fp32_ceiling.py

On one CUDA card (sm_90a), builds a kernel that runs the assign launch's
register tile (8 × 16 accumulators a thread, 128 threads, two CTAs an SM)
on operands already in registers, with no memory traffic, and times it
with CUDA events: the FP32 FMA rate compiled code of this shape reaches on
this card. Then profiles one sweep at 1,000,000 × 64, K = 256 (the smoke's
standard-normal data, seeded) and reports the assign launch's rate as a
share of that one and of the 67 TFLOP/s data-sheet peak.

Prints the card's name and power limit, then one JSON object. Exits 1
without a CUDA card. Nothing in the port reads its output.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from oryx_tpu_torch.ops import _build
from oryx_tpu_torch.ops import kernels as K

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(128, 2) ffma_tile(float* out, int iters) {
  float acc[8][16], a[8], b[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3f + i;
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = threadIdx.x * 2e-3f - j;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      // new operands, as far as the compiler knows: no hoisting, no cost
#pragma unroll
      for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(a[i]));
#pragma unroll
      for (int j = 0; j < 16; ++j) asm volatile("" : "+f"(b[j]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int ffma_tile_launch(float* out, int ctas, int iters, void* stream) {
  ffma_tile<<<ctas, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
CTAS, ITERS = 264, 4000  # two CTAs on each of 132 SMs


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fp32_ceiling.cu"
    lib = _build.BUILD_DIR / "libfp32_ceiling.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("fp32_ceiling: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.gpu_query(), flush=True)
    fn = build().ffma_tile_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(CTAS * 128, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def tile():
        cs.check(fn(out.data_ptr(), CTAS, ITERS, stream) == 0, "ffma_tile: launch")

    tile_ms = cs.time_ms(tile, reps=5)
    ceiling = 2.0 * CTAS * 128 * ITERS * 4 * 8 * 16 / (tile_ms * 1e9)

    rng = np.random.default_rng(cs.SEED)
    pts = torch.from_numpy(
        rng.standard_normal((cs.KM_N, cs.KM_D), dtype=np.float32)).to(dev)
    centers = torch.from_numpy(
        rng.standard_normal((cs.KM_K, cs.KM_D), dtype=np.float32)).to(dev)
    args = (pts, torch.ones(cs.KM_N, device=dev), centers)
    prof = cs.sweep_profile(args, "1M x 64")
    assign_ms = next(ms for name, ms in prof["kernels_ms"].items()
                     if name.startswith("assign_kernel"))
    rate = 2.0 * cs.KM_N * cs.KM_K * cs.KM_D / (assign_ms * 1e9)
    print(json.dumps({
        "ffma_tile_ms": tile_ms, "ffma_tile_tflops": ceiling,
        "assign_ms": assign_ms, "assign_tflops": rate,
        "assign_share_of_ffma_tile": rate / ceiling,
        "assign_share_of_peak": rate * 1e12 / cs.PEAK_FLOPS[torch.float32],
        "sweep_profile": prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
