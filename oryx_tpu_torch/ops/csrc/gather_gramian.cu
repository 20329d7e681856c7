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
// What bounds it on this card. The least work is k(k+1)/2 multiply-adds
// per valid entry for the symmetric A plus k for b; the least traffic is
// the slot arrays (scols, w, coef: 12 bytes per slot entry), each distinct
// gathered factor row once, and A and b written once. On a user block
// (T = 16, ~9 entries per row) the (block+1) x k x k float32 A write
// dominates: bytes. On an item block (T = 128, ~90 entries per row) the two
// are close: at k = 50, 4,999 rows and ~0.45 M entries, ~1.2 GFLOP
// (~0.018 ms at the 67 TFLOP/s float32 CUDA-core peak) against ~80 MB
// (~0.024 ms at 3.35 TB/s), so bytes, narrowly. This kernel computes the
// whole tile, more than twice the least multiply-adds at k = 50.
//
// Design. The TPU kernel walks slots on a sequential grid and keeps the
// owner row's output block resident across its slots; Hopper runs blocks in
// parallel and in no order, so that does not carry over. A row's work is
// cut into bounded units instead, so no block serialises a popular item:
//   * the schedule (kernels.gather_gramian_schedule, built once per packed
//     block) cuts each owner row's valid slots into UNITS of consecutive
//     slots holding at most U entries (U a multiple of T, 512 by default; a
//     slot is never split). A row with one unit is a single-unit row, a
//     row with more a split row. It lists every unit, longest first (the
//     long units start first and the short ones fill in at the end;
//     tune_gather_gramian.py times the same units in slot order), then
//     one empty item per row that no valid slot visits (the spill row
//     included);
//   * pass 1, gather_gramian_kernel: one block per (work item, 64 x 64
//     tile of [A | b]), ceil(k/64) x ceil((k+1)/64) tiles: b is column k of
//     the product of y (left) and [w*y | coef] (right), so it costs no
//     extra pass (at k = 50, one tile holds A and b). The block loops over
//     its unit's slots and each slot's entries in chunks of 32: it gathers
//     the 32 factor rows' column slices into shared memory (coalesced:
//     consecutive threads read consecutive features of one row), weighting
//     the right operand once per element, and each of its 256 threads
//     accumulates a 4 x 4 sub-tile in float32 registers from two 16-byte
//     shared loads per entry (16 FMAs); warps whose rows all lie past k
//     skip the products. It writes its whole tile once, zeros included,
//     through a shared-memory tile so that consecutive threads write
//     consecutive columns (the user block's cost is mostly this write): a
//     single-unit row's (and an unvisited row's) straight into A and b, a
//     split row's unit into its own slot of a workspace;
//   * pass 2, gather_gramian_reduce (launched only when the block has a
//     split row): for each split row, the units' partial tiles summed in
//     unit order into A and b.
// No atomics, and every sum in a fixed order (the launch order of the
// units changes no bits): the same bits on every run. No block runs more
// than U entries, whatever the skew.
//
// Workspace bound: the schedule keeps the units of split rows at or below
// (block+1)/2, raising U for the block where needed, so the workspace,
// units x k(k+1) x 4 bytes, never exceeds the A output's own
// (block+1) x k^2 x 4 bytes at any k >= 1 (up to the gate, k <= 256).
// The products run on CUDA cores, not tensor cores: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 32;    // slot entries staged in shared memory per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kReduceThreads = 256;
constexpr int kTilePitch = kTile + 4;  // the finished tile's row in shared memory

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the weight rounded to y's type, as a float
__device__ __forceinline__ float round_like(float v, const float*) { return v; }
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// work: (n_work, 4) int32 items {row, first slot, end slot, workspace slot};
// workspace slot -1 writes into a and b, else into ws[slot] (k*k + k floats).
// The block's tile (ti, tj) is rows i0 .. i0+63 of A and columns
// j0 .. j0+63 of [A | b]: the product of L = y (unweighted) and
// R = [w * y | coef], so column k of the right operand gives b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_gramian_kernel(const T* __restrict__ y, const int* __restrict__ work,
                      const int* __restrict__ scols, const float* __restrict__ w,
                      const float* __restrict__ coef,
                      const int* __restrict__ slens, float* __restrict__ ws,
                      float* __restrict__ a_out, float* __restrict__ b_out,
                      int t, int k, int n_col_tiles) {
  __shared__ __align__(16) float lhs[kChunk][kTile];  // y[i0 + f]
  __shared__ __align__(16) float rhs[kChunk][kTile];  // w*y[j0 + f], coef at k
  // the finished tile, kTilePitch floats a row: each thread's 16-byte
  // stores of its 4 x 4 block and the row-wise reads that follow are free
  // of bank conflicts
  __shared__ __align__(16) float tile[kTile * kTilePitch];
  __shared__ float ws_w[kChunk];
  __shared__ float cs[kChunk];
  __shared__ int cols[kChunk];

  const int* item = work + (size_t)blockIdx.x * 4;
  const int row = item[0];
  const int s_begin = item[1];
  const int s_end = item[2];
  const int slot = item[3];
  const int i0 = (blockIdx.y / n_col_tiles) * kTile;
  const int j0 = (blockIdx.y % n_col_tiles) * kTile;
  const bool diag = i0 == j0;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns j0 + 4*tx .. +3
  const int ty = tid / 16;  // rows i0 + 4*ty .. +3
  // a warp holds rows i0 + 8*warp .. +7: past k it only writes zeros
  const bool active = i0 + 8 * (tid / 32) < k;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int s = s_begin; s < s_end; ++s) {
    const int len = slens[s];
    for (int e0 = 0; e0 < len; e0 += kChunk) {
      const int n = min(kChunk, len - e0);
      if (tid < kChunk) {
        const bool live = tid < n;
        const size_t off = (size_t)s * t + e0 + tid;
        cols[tid] = live ? scols[off] : 0;
        ws_w[tid] = live ? round_like(w[off], y) : 0.f;
        cs[tid] = live ? round_like(coef[off], y) : 0.f;
      }
      __syncthreads();
      // every row of the chunk is written, rows past n as zeros, so the
      // product below may run past n to a multiple of 4
      for (int idx = tid; idx < kChunk * kTile; idx += kThreads) {
        const int e = idx / kTile;
        const int f = idx % kTile;
        const bool live = e < n;
        const size_t base = (size_t)cols[e] * k;
        const int i = i0 + f;
        const int j = j0 + f;
        const float li = (live && i < k) ? load_f32(y + base + i) : 0.f;
        float rj = 0.f;
        if (live && j < k)
          rj = ws_w[e] * (diag ? li : load_f32(y + base + j));
        else if (live && j == k)
          rj = cs[e];
        lhs[e][f] = li;
        rhs[e][f] = rj;
      }
      __syncthreads();
      if (active) {
        const int n4 = (n + 3) & ~3;
#pragma unroll 4
        for (int e = 0; e < n4; ++e) {
          const float4 l4 = *reinterpret_cast<const float4*>(&lhs[e][4 * ty]);
          const float4 r4 = *reinterpret_cast<const float4*>(&rhs[e][4 * tx]);
          const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
          const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[p][q] = fmaf(lv[p], rv[q], acc[p][q]);
        }
      }
      __syncthreads();
    }
  }

  float* a_dst;
  float* b_dst;
  if (slot < 0) {
    a_dst = a_out + (size_t)row * k * k;
    b_dst = b_out + (size_t)row * k;
  } else {
    a_dst = ws + (size_t)slot * (k * k + k);
    b_dst = a_dst + k * k;
  }
  // the tile through shared memory, then out row by row: consecutive
  // threads write consecutive columns
#pragma unroll
  for (int p = 0; p < 4; ++p)
    *reinterpret_cast<float4*>(&tile[(4 * ty + p) * kTilePitch + 4 * tx]) =
        make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  __syncthreads();
  const int rows = min(kTile, k - i0);
  const int width = min(kTile, k + 1 - j0);
  for (int idx = tid; idx < rows * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx % width;
    const float v = tile[r * kTilePitch + c];
    const int i = i0 + r;
    const int j = j0 + c;
    if (j < k)
      a_dst[(size_t)i * k + j] = v;
    else
      b_dst[i] = v;
  }
}

// split: (n_split, 3) int32 {row, first workspace slot, end slot}; one
// thread per output element of a split row, its units summed in order
__global__ void __launch_bounds__(kReduceThreads)
gather_gramian_reduce(const float* __restrict__ ws, const int* __restrict__ split,
                      float* __restrict__ a_out, float* __restrict__ b_out,
                      int k) {
  const int* item = split + (size_t)blockIdx.x * 3;
  const int row = item[0];
  const int p_begin = item[1];
  const int p_end = item[2];
  const int kk = k * k;
  const int n = kk + k;
  const int e = blockIdx.y * kReduceThreads + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int p = p_begin; p < p_end; ++p) sum += ws[(size_t)p * n + e];
  if (e < kk)
    a_out[(size_t)row * kk + e] = sum;
  else
    b_out[(size_t)row * k + e - kk] = sum;
}

}  // namespace

// y: (R, k) float32 (y_bf16 == 0) or bfloat16; work: (n_work, 4) and
// split: (n_split, 3) int32, the schedule; scols, w, coef: (S, t);
// slens: (S,); ws: (workspace slots, k*k + k) float32 (may be null when
// n_split == 0); a: (rows_out, k, k) and b: (rows_out, k) float32, every
// element written. Launches pass 1, then pass 2 when n_split > 0. Returns
// the cudaError_t of the launches.
extern "C" int oryx_gather_gramian(const void* y, int y_bf16, const int* work,
                                   int n_work, const int* split, int n_split,
                                   const int* scols, const float* w,
                                   const float* coef, const int* slens, float* ws,
                                   float* a, float* b, int t, int k,
                                   void* stream) {
  if (n_work <= 0 || k <= 0) return (int)cudaSuccess;
  // row tiles over A's k rows, column tiles over [A | b]'s k + 1 columns
  const int n_row_tiles = (k + kTile - 1) / kTile;
  const int n_col_tiles = (k + 1 + kTile - 1) / kTile;
  const dim3 grid(n_work, n_row_tiles * n_col_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_bf16) {
    gather_gramian_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), work, scols, w, coef, slens, ws,
        a, b, t, k, n_col_tiles);
  } else {
    gather_gramian_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(y), work, scols, w, coef, slens, ws, a, b, t,
        k, n_col_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split <= 0) return (int)err;
  const dim3 rgrid(n_split, (k * k + k + kReduceThreads - 1) / kReduceThreads);
  gather_gramian_reduce<<<rgrid, kReduceThreads, 0, st>>>(ws, split, a, b, k);
  return (int)cudaGetLastError();
}
