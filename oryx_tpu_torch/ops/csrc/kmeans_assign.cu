// One Lloyd sweep of k-means, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of oryx_tpu/ops/pallas_kernels.py:
// 357-388 (pallas_call in `_call` :391-415, entry kmeans_assign_accumulate
// :418-448; the JAX k-means trainer calls `_call` once per sweep). For points
// P (N,D), weights w (N,) and centres C (K,D), all float32, it computes
//   sums   (K,D) = sum over p with a(p) = c of w_p * P[p]
//   counts (K,)  = sum over p with a(p) = c of w_p
//   cost   ()    = sum over p of w_p * d2(p, a(p))
// where d2(p,c) = max(|p|^2 - 2 p.c + |c|^2, 0) (this expansion, as the TPU
// kernel computes it) and a(p) is the nearest centre, ties to the lowest
// index.
//
// What bounds it on an H100: the cross term p.c, 2*N*K*D float32 operations
// (at 1M points, D = 64, K = 256: 33 GFLOP, 0.5 ms at 67 TFLOP/s), against
// N*D*4 bytes of points read once (0.08 ms at 3.35 TB/s): operations.
//
// Design. The TPU kernel carries the (K,D) sums in one output block across
// a sequential grid. Hopper blocks run in parallel and in no order, so the
// sweep is three launches, none with atomics, each summing in an order that
// N, K and D alone fix (never the card), so a sweep gives the same bits on
// every run:
//   1. assign_kernel: one CTA per 128-point tile. Points and centres pass
//      through shared memory in chunks of 128 centres x 32 dimensions, so any
//      K and D fit. Each thread keeps an 8 x 8 register tile of cross terms
//      (float32 FMA on CUDA cores, summed over d in ascending order), then
//      keeps the nearest centre with a strict < in ascending centre order:
//      clamped zeros tie to the lower index, as the TPU kernel's first_min.
//      It writes each point's centre and its d2.
//   2. partial_kernel: P CTAs, P chosen by the caller from N, K and D. CTA b
//      walks its contiguous range of points in index order and adds w*p into
//      its own (K,D) sums, (K,) counts and cost. Each entry has one owner
//      thread: thread t owns column t of every centre's sums, so no thread
//      skips a point, and the walk is a chain of shared-memory read-modify-
//      writes with the next 32 points' loads in flight. The slab lives in
//      shared memory where it fits, else in the CTA's workspace slab in
//      device memory.
//   3. reduce_kernel: each output entry sums the P slabs in order 0..P-1.
// Points of weight 0 contribute nothing. N, D and K are not padded: the
// loops mask the ragged edges, which is what the TPU's FAR_AWAY pad centres
// achieve. Tensor cores (wgmma) and a fused reduction are left for later.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads per CTA
constexpr int kRP = 8;         // points per thread
constexpr int kRC = 8;         // centres per thread
constexpr int kTP = 16 * kRP;  // points per tile
constexpr int kTC = 16 * kRC;  // centres per chunk
constexpr int kTD = 32;        // dimensions per chunk
constexpr int kWalkTile = 32;  // points per step of the partial walk: one per lane
// largest per-CTA slab kept in shared memory: two CTAs still fit on an SM
constexpr long long kSlabSmemBytes = 100 * 1024;
static_assert(kTP + kTC <= kThreads, "one thread per tile norm");

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ points, const float* __restrict__ centers,
              int n, int d, int k, int* __restrict__ assign,
              float* __restrict__ min_d2) {
  __shared__ float ps[kTD][kTP + 1];  // +1: the transposing stores are conflict-free
  __shared__ float cs[kTD][kTC + 1];
  __shared__ float psq_s[kTP];
  __shared__ float csq_s[kTC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // centres tx + 16 j
  const int ty = tid >> 4;  // points ty + 16 i
  const int csq_lane = tid - (kThreads - kTC);  // >= 0: this thread sums |c|^2
  const long long p0 = (long long)blockIdx.x * kTP;

  float run_best[kRP];
  int run_idx[kRP];
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    run_best[i] = INFINITY;
    run_idx[i] = 0;
  }
  float psq = 0.f;  // |p|^2 of tile point `tid` (tid < kTP), from the first chunk

  for (int c0 = 0; c0 < k; c0 += kTC) {
    float acc[kRP][kRC];
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) acc[i][j] = 0.f;
    float csq = 0.f;

    for (int d0 = 0; d0 < d; d0 += kTD) {
      __syncthreads();  // every reader of the previous chunk is done
      for (int e = tid; e < kTP * kTD; e += kThreads) {
        const int r = e / kTD, dd = e % kTD;
        const long long p = p0 + r;
        const int col = d0 + dd;
        ps[dd][r] = (p < n && col < d) ? points[p * d + col] : 0.f;
      }
      for (int e = tid; e < kTC * kTD; e += kThreads) {
        const int r = e / kTD, dd = e % kTD;
        const int c = c0 + r, col = d0 + dd;
        cs[dd][r] = (c < k && col < d) ? centers[(long long)c * d + col] : 0.f;
      }
      __syncthreads();
      if (c0 == 0 && tid < kTP) {
        for (int dd = 0; dd < kTD; ++dd) psq = fmaf(ps[dd][tid], ps[dd][tid], psq);
      }
      if (csq_lane >= 0) {
        for (int dd = 0; dd < kTD; ++dd)
          csq = fmaf(cs[dd][csq_lane], cs[dd][csq_lane], csq);
      }
#pragma unroll 4
      for (int dd = 0; dd < kTD; ++dd) {
        float a[kRP], b[kRC];
#pragma unroll
        for (int i = 0; i < kRP; ++i) a[i] = ps[dd][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kRC; ++j) b[j] = cs[dd][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRP; ++i)
#pragma unroll
          for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    if (c0 == 0 && tid < kTP) psq_s[tid] = psq;
    if (csq_lane >= 0) csq_s[csq_lane] = csq;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const float pv = psq_s[ty + 16 * i];
      float best = INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        const int c = c0 + tx + 16 * j;  // ascending in j
        if (c < k) {
          const float v = fmaxf(pv - 2.0f * acc[i][j] + csq_s[tx + 16 * j], 0.f);
          if (v < best) {
            best = v;
            bi = c;
          }
        }
      }
      // the 16 lanes holding this point: smallest d2, then smallest index
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob < best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      // a later chunk holds only larger indices: it wins only when strictly nearer
      if (best < run_best[i]) {
        run_best[i] = best;
        run_idx[i] = bi;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const long long p = p0 + ty + 16 * i;
      if (p < n) {
        assign[p] = run_idx[i];
        min_d2[p] = run_best[i];
      }
    }
  }
}

// Slab layout, e = K*D + K + 1 floats: sums (K,D), counts (K,), cost; in
// dynamic shared memory when kSmemSlab. Thread t owns column cb + t of the
// sums of every centre, for each column pass cb; the owner of column 0 also
// owns the counts and the cost. A thread keeps its column of kWalkTile points
// in registers, and lane r of each warp holds point r's weight, d2 and
// centre, handed to the other lanes by shuffles: the walk needs no barrier,
// and the next tile's loads are in flight while a tile is walked.
template <bool kSmemSlab>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ points, const float* __restrict__ weights,
               const int* __restrict__ assign, const float* __restrict__ min_d2,
               int n, int d, int k, long long per, float* __restrict__ ws) {
  extern __shared__ float smem[];
  const long long e = (long long)k * d + k + 1;
  float* part = ws + (long long)blockIdx.x * e;
  float* slab = kSmemSlab ? smem : part;
  const int cols = blockDim.x, t = threadIdx.x, lane = t & 31;
  for (long long i = t; i < e; i += cols) slab[i] = 0.f;
  __syncthreads();

  const long long start = (long long)blockIdx.x * per;
  const long long end = min((long long)n, start + per);
  float cost = 0.f;
  for (int cb = 0; cb < d; cb += cols) {
    const int col = cb + t;
    float xv[kWalkTile], wv = 0.f, dv = 0.f;
    int cv = 0;
    auto fetch = [&](long long p0) {  // weight 0 past the range: skipped
#pragma unroll
      for (int r = 0; r < kWalkTile; ++r) {
        const long long p = p0 + r;
        xv[r] = (p < end && col < d) ? points[p * d + col] : 0.f;
      }
      const bool ok = p0 + lane < end;
      wv = ok ? weights[p0 + lane] : 0.f;
      dv = ok ? min_d2[p0 + lane] : 0.f;
      cv = ok ? assign[p0 + lane] : 0;
    };
    if (start < end) fetch(start);
    for (long long p0 = start; p0 < end; p0 += kWalkTile) {
      float x[kWalkTile];
#pragma unroll
      for (int r = 0; r < kWalkTile; ++r) x[r] = xv[r];
      const float w_lane = wv, d_lane = dv;
      const int c_lane = cv;
      if (p0 + kWalkTile < end) fetch(p0 + kWalkTile);
#pragma unroll
      for (int r = 0; r < kWalkTile; ++r) {  // in point order
        const float w = __shfl_sync(0xffffffffu, w_lane, r);
        const float d2 = __shfl_sync(0xffffffffu, d_lane, r);
        const int c = __shfl_sync(0xffffffffu, c_lane, r);
        if (w != 0.f && col < d) {
          float* s = slab + (long long)c * d + col;
          *s = fmaf(w, x[r], *s);
          if (col == 0) {
            slab[(long long)k * d + c] += w;
            cost = fmaf(d2, w, cost);
          }
        }
      }
    }
  }
  __syncthreads();
  if (t == 0) slab[e - 1] = cost;
  if (kSmemSlab) {
    __syncthreads();
    for (long long i = t; i < e; i += cols) part[i] = slab[i];
  }
}

__global__ void __launch_bounds__(128)
reduce_kernel(const float* __restrict__ ws, int parts, long long e,
              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e) return;
  float s = 0.f;
#pragma unroll 16
  for (int b = 0; b < parts; ++b) s += ws[(long long)b * e + i];
  out[i] = s;
}

}  // namespace

// points (n,d), weights (n,), centers (k,d) float32; scratch assign (n,)
// int32, min_d2 (n,) and ws (parts, k*d+k+1) float32; out (k*d+k+1,)
// float32 receives sums, counts and cost. Returns a CUDA error code (0 = ok).
extern "C" int oryx_kmeans_assign(const float* points, const float* weights,
                                  const float* centers, int n, int d, int k,
                                  int parts, int* assign, float* min_d2,
                                  float* ws, float* out, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || parts <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long e = (long long)k * d + k + 1;

  const int tiles = (n + kTP - 1) / kTP;
  assign_kernel<<<tiles, kThreads, 0, s>>>(points, centers, n, d, k, assign, min_d2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long slab_bytes = e * (long long)sizeof(float);
  const bool slab_in_smem = slab_bytes <= kSlabSmemBytes;
  const int cols = d < kThreads ? (d + 31) / 32 * 32 : kThreads;  // walk threads
  const size_t smem = slab_in_smem ? (size_t)slab_bytes : 0;
  const long long per = (n + (long long)parts - 1) / parts;
  if (slab_in_smem) {
    err = cudaFuncSetAttribute(partial_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    partial_kernel<true><<<parts, cols, smem, s>>>(points, weights, assign, min_d2,
                                                  n, d, k, per, ws);
  } else {
    err = cudaFuncSetAttribute(partial_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    partial_kernel<false><<<parts, cols, smem, s>>>(points, weights, assign, min_d2,
                                                   n, d, k, per, ws);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int blocks = (int)((e + 127) / 128);
  reduce_kernel<<<blocks, 128, 0, s>>>(ws, parts, e, out);
  return (int)cudaGetLastError();
}
