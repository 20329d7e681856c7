// Fused gather -> per-slot Gramian -> per-row accumulate for one ALS row
// block, by hand for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_make_gather_gramian_kernel`
// (oryx_tpu/ops/pallas_kernels.py:221-289, entry gather_gramian_accumulate
// :292-354), which the reference trainer calls from train._solve_block.
//
// Computes, for every slot s of the block (slots arrive sorted by owner row):
//   A[srow[s]] += sum_t w[s,t]    * y[scols[s,t]]^T y[scols[s,t]]   (k x k)
//   b[srow[s]] += sum_t coef[s,t] * y[scols[s,t]]                   (k)
// over the slot's valid entries t < slens[s]. w and coef are rounded to y's
// type before the products (as the reference casts them at :279,:284);
// products and sums are float32.
//
// What bounds it on this card: operations. Each gathered factor row (k
// values) feeds k*k multiply-adds, so at k = 50 the kernel does ~2*k = 100
// flops per byte of y it reads, far above the H100's ~20 flop/byte float32
// CUDA-core balance (67 TFLOP/s over 3.35 TB/s). The gather itself is
// random-row but row-contiguous: one factor row is k consecutive values.
//
// Design. The TPU kernel walks slots on a sequential grid and keeps the
// owner row's output block resident across its slots; Hopper runs blocks in
// parallel and in no order, so that does not carry over. Here:
//   * the wrapper turns the sorted owner rows into per-row slot ranges
//     [row_start[r], row_start[r+1]) (plain torch searchsorted);
//   * the grid is (block + 1) x ceil(k/64)^2: each CTA owns ONE output row's
//     64 x 64 Gramian tile (and, on diagonal tiles, the matching 64-slice of
//     the right-hand side) and loops over that row's slots and over the
//     slot's entries in chunks of 32;
//   * per chunk the CTA gathers the 32 factor rows' two 64-wide column
//     slices into shared memory (coalesced: consecutive threads read
//     consecutive features of one row) and each of its 256 threads
//     accumulates a 4 x 4 sub-tile in float32 registers;
//   * the CTA writes its whole tile once, zeros included, so rows that no
//     slot visits and the spill row (row `block`) come out exactly 0
//     without a memset, and no atomics are needed: the result is
//     deterministic, run to run.
// The tile design supports any k, so the reference's gate (k <= 256) is kept
// unchanged. Known weak spot: a hot row (a popular item) is serialised in
// one CTA while the others finish early; the products run on CUDA cores,
// not tensor cores. Both are work for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 32;    // slot entries staged in shared memory per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the weight rounded to y's type, as a float
__device__ __forceinline__ float round_like(float v, const float*) { return v; }
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_gramian_kernel(const T* __restrict__ y, const int* __restrict__ row_start,
                      const int* __restrict__ scols, const float* __restrict__ w,
                      const float* __restrict__ coef,
                      const int* __restrict__ slens, float* __restrict__ a_out,
                      float* __restrict__ b_out, int t, int k, int n_tiles) {
  __shared__ float yi[kChunk][kTile];  // features i0 .. i0+63 of the chunk
  __shared__ float yj[kChunk][kTile];  // features j0 .. j0+63 (off-diagonal)
  __shared__ float ws[kChunk];
  __shared__ float cs[kChunk];
  __shared__ int cols[kChunk];

  const int row = blockIdx.x;
  const int ti = blockIdx.y / n_tiles;
  const int tj = blockIdx.y % n_tiles;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool diag = ti == tj;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  float bacc = 0.f;  // b[i0 + tid] on diagonal tiles, tid < kTile

  const int s_end = row_start[row + 1];
  for (int s = row_start[row]; s < s_end; ++s) {
    const int len = slens[s];
    for (int e0 = 0; e0 < len; e0 += kChunk) {
      const int n = min(kChunk, len - e0);
      if (tid < kChunk) {
        const bool live = tid < n;
        const size_t off = (size_t)s * t + e0 + tid;
        cols[tid] = live ? scols[off] : 0;
        ws[tid] = live ? round_like(w[off], y) : 0.f;
        cs[tid] = live ? round_like(coef[off], y) : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < kChunk * kTile; idx += kThreads) {
        const int e = idx / kTile;
        const int f = idx % kTile;
        const bool live = e < n;
        const size_t base = (size_t)cols[e] * k;
        yi[e][f] = (live && i0 + f < k) ? load_f32(y + base + i0 + f) : 0.f;
        if (!diag)
          yj[e][f] = (live && j0 + f < k) ? load_f32(y + base + j0 + f) : 0.f;
      }
      __syncthreads();
      const float(*yr)[kTile] = diag ? yi : yj;
      for (int e = 0; e < n; ++e) {
        const float we = ws[e];
        float ap[4], bq[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) ap[p] = we * yi[e][ty + 16 * p];
#pragma unroll
        for (int q = 0; q < 4; ++q) bq[q] = yr[e][tx + 16 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(ap[p], bq[q], acc[p][q]);
      }
      if (diag && tid < kTile) {
        for (int e = 0; e < n; ++e) bacc = fmaf(cs[e], yi[e][tid], bacc);
      }
      __syncthreads();
    }
  }

  float* a_row = a_out + (size_t)row * k * k;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (i < k && j < k) a_row[(size_t)i * k + j] = acc[p][q];
    }
  }
  if (diag && tid < kTile && i0 + tid < k) b_out[(size_t)row * k + i0 + tid] = bacc;
}

}  // namespace

// y: (R, k) float32 (y_bf16 == 0) or bfloat16; row_start: (rows_out + 1,)
// slot ranges per output row; scols, w, coef: (S, t); slens: (S,);
// a: (rows_out, k, k) and b: (rows_out, k) float32, every element written.
// Returns the cudaError_t of the launch.
extern "C" int oryx_gather_gramian(const void* y, int y_bf16, const int* row_start,
                                   const int* scols, const float* w,
                                   const float* coef, const int* slens, float* a,
                                   float* b, int rows_out, int t, int k,
                                   void* stream) {
  if (rows_out <= 0 || k <= 0) return (int)cudaSuccess;
  const int n_tiles = (k + kTile - 1) / kTile;
  const dim3 grid(rows_out, n_tiles * n_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_bf16) {
    gather_gramian_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), row_start, scols, w, coef, slens, a,
        b, t, k, n_tiles);
  } else {
    gather_gramian_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(y), row_start, scols, w, coef, slens, a, b, t,
        k, n_tiles);
  }
  return (int)cudaGetLastError();
}
