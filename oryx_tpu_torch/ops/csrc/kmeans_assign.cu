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
// (at 1M points, D = 64, K = 256: 33 GFLOP, 0.49 ms at 67 TFLOP/s), against
// N*D*4 bytes of points read once (0.08 ms at 3.35 TB/s): operations, on the
// CUDA cores. Every sum is an fmaf chain in a fixed order (tensor cores
// would change the bits), and the outputs are the same bits as the first
// version of this kernel on every input.
//
// Design. The TPU kernel carries the (K,D) sums in one output block across
// a sequential grid. Hopper blocks run in parallel and in no order, so the
// sweep is three launches, none with atomics, each summing in an order that
// N, K and D alone fix (never the card), so a sweep gives the same bits on
// every run. The host's `kmeans_sweep_plan` (ops/kernels.py) gives the
// geometry; this entry checks it.
//   1. assign_kernel: 128 threads a CTA, two CTAs an SM; each CTA walks
//      64-point tiles (tile b, b + CTAs, ...) with one load pipeline across
//      them, so the next tile's loads are in flight while a tile finishes.
//      Centres come in chunks of 256, dimensions in stages of 32; both pass
//      through shared memory by cp.async (16-byte vectors when the rows are
//      16-byte aligned, else one float at a time), two stages deep. With at
//      most two stages a tile (K <= 256, D <= 64) the centres are loaded
//      once and stay. Rows are padded to 36 floats, so a thread reads 4
//      dimensions of a row in one 16-byte load and 8 threads reading 8
//      consecutive rows hit 8 different bank quads. Thread (ty, tx) keeps an
//      8 x 16 register tile of cross terms, points ty + 8 i and centres
//      tx + 16 j: per 4 dimensions it loads 8 + 16 vectors for 512 FMAs, so
//      shared memory delivers 0.75 bytes an FMA (an 8 x 8 tile: 1.0, which
//      is all of the SM's 128 bytes a clock at its 128 FMAs a clock). Each
//      cross term is an fmaf chain over d = 0 .. D-1 in order, |p|^2 and
//      |c|^2 likewise. Then the nearest centre: strict < in ascending
//      centre order within a thread, a (value, index) shuffle across the 16
//      lanes of a point, strict < across chunks: clamped zeros tie to the
//      lower index, as the TPU kernel's first_min. It writes each point's
//      centre and its d2.
//   2. partial_kernel: one CTA per part; CTA b walks its contiguous range
//      of points in index order and adds w*p into its own (K,D) sums, (K,)
//      counts and cost. Each slab entry has one owner thread, so each entry
//      is one fmaf (counts: one add) chain in point order: the CTA has G
//      column groups (G a power of 2, up to 512 threads) of D (rounded up
//      to 32) threads, and thread (g, t) owns column t of the centres
//      c = g mod G. A warp lies in one group and visits only its group's
//      points (one ballot per 32 points). The points come through shared
//      memory three tiles ahead, each tile one bulk copy by the Tensor
//      Memory Accelerator. The slab lives in shared memory where it fits,
//      else in the CTA's workspace slab in device memory.
//   3. reduce_kernel: each output entry sums the P slabs in order 0..P-1.
// Points of weight 0 contribute nothing. N, D and K are not padded: the
// loads zero-fill and the loops mask the ragged edges, which is what the
// TPU's FAR_AWAY pad centres achieve.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

// The assign launch; ops/kernels.py's KMEANS_* constants mirror these.
constexpr int kThreads = 128;   // 8 x 16 threads per assign CTA
constexpr int kTY = kThreads / 16;
constexpr int kRP = 8;          // points per thread
constexpr int kRC = 16;         // centres per thread
constexpr int kTP = kTY * kRP;  // points per tile
constexpr int kTC = 16 * kRC;   // centres per chunk
constexpr int kTD = 32;         // dimensions per stage
constexpr int kLd = kTD + 4;    // shared row stride in floats: 16-byte rows
// two point buffers and two centre buffers, in floats
constexpr int kAssignSmemBytes = 2 * (kTP + kTC) * kLd * (int)sizeof(float);
constexpr int kAssignMinBlocks = 2;  // 65,536 registers: 255 a thread
// The walk.
constexpr int kWalkThreads = 512;  // at most, in column groups
constexpr int kWalkTile = 32;      // points per step of the partial walk: one per lane
constexpr int kWalkStages = 4;     // walk tiles in shared memory: three in flight
// largest shared memory a CTA may use on an H100
constexpr long long kMaxSmemBytes = 232448;
static_assert(kTP <= kThreads && kTC % kThreads == 0, "thread rows for the tile norms");
static_assert(kLd % 4 == 0, "16-byte shared rows");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, in flight until the group is waited on;
// bytes = 0 fills the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A shared-memory barrier that completes when one arrival and `bytes` of bulk
// copies have landed (the Tensor Memory Accelerator's transaction count).
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect_bytes(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity; a phase that never completes
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global -> shared
// by the Tensor Memory Accelerator, counted on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Rows [r0, r0 + kRows) of a (rows, d) matrix, dimensions [d0, d0 + 32),
// into a kRows x kLd shared tile; rows past `rows` and dimensions past d are
// zeros.
template <bool kVec, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long rows, int d, long long r0, int d0,
                                          int tid) {
  if (kVec) {  // 8 threads per row, 16 bytes each
#pragma unroll
    for (int q = 0; q < kRows * kTD / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e >> 3, col = d0 + (e & 7) * 4;
      const bool ok = r0 + r < rows && col < d;  // d % 4 == 0: a quad is all in or out
      cp_async16(dst + r * kLd + (e & 7) * 4, ok ? src + (r0 + r) * d + col : src,
                 ok ? 16 : 0);
    }
  } else {  // 32 threads per row, 4 bytes each
#pragma unroll
    for (int q = 0; q < kRows * kTD / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e >> 5, col = d0 + (e & 31);
      const bool ok = r0 + r < rows && col < d;
      cp_async4(dst + r * kLd + (e & 31), ok ? src + (r0 + r) * d + col : src,
                ok ? 4 : 0);
    }
  }
}

// Each of a thread's kRP points' nearest centre among its kRC centres of the
// chunk from c0: d2 = max(|p|^2 - 2 p.c + |c|^2, 0), strict < in ascending
// centre order (kFull: all kTC centres of the chunk exist).
template <bool kFull>
__device__ __forceinline__ void chunk_nearest(const float (&acc)[kRP][kRC],
                                              const float* psq_s, const float* csq_s,
                                              int c0, int k, int tx, int ty,
                                              float (&best)[kRP], int (&bi)[kRP]) {
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    const float pv = psq_s[ty + kTY * i];
    best[i] = INFINITY;
    bi[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < kRC; ++j) {
      const int c = c0 + tx + 16 * j;  // ascending in j
      if (kFull || c < k) {
        const float v = fmaxf(pv - 2.0f * acc[i][j] + csq_s[tx + 16 * j], 0.f);
        if (v < best[i]) {
          best[i] = v;
          bi[i] = c;
        }
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kAssignMinBlocks)
assign_kernel(const float* __restrict__ points, const float* __restrict__ centers,
              int n, int d, int k, int tiles, int* __restrict__ assign,
              float* __restrict__ min_d2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float psq_s[kTP];
  __shared__ float csq_s[kTC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // centres tx + 16 j
  const int ty = tid >> 4;  // points ty + kTY i
  const int nd = (d + kTD - 1) / kTD;
  const int stages = nd * ((k + kTC - 1) / kTC);  // per tile
  // this CTA's tiles: blockIdx.x + gridDim.x u; its stages run as one sequence,
  // so the next tile's first stage loads while this tile's last one computes
  const int total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * stages;
  auto tile_p0 = [&](int gs) {
    return ((long long)blockIdx.x + (long long)(gs / stages) * gridDim.x) * kTP;
  };
  // two point buffers, then two centre buffers; with at most two stages a
  // tile, centre slice s stays in buffer s for every tile of the CTA
  float* const pbuf = smem;
  float* const cbuf = smem + 2 * kTP * kLd;
  const bool resident = stages <= 2;
  auto load_centres = [&](int s, float* buf) {
    load_tile<kVec, kTC>(buf, centers, k, d, (s / nd) * kTC, (s % nd) * kTD, tid);
  };
  auto load_stage = [&](int gs) {
    const int s = gs % stages;
    load_tile<kVec, kTP>(pbuf + (gs & 1) * kTP * kLd, points, n, d, tile_p0(gs),
                         (s % nd) * kTD, tid);
    if (!resident) load_centres(s, cbuf + (gs & 1) * kTC * kLd);
  };

  // the running nearest centre of point ty + kTY tx, kept by lane tx < kRP
  float run_best = INFINITY;
  int run_idx = 0;
  float acc[kRP][kRC];
  float psq = 0.f;  // tid < kTP: |p|^2 of tile point tid, over chunk 0's stages
  constexpr int kCsq = kTC / kThreads;
  float csq[kCsq];  // |c|^2 of chunk centres tid + kThreads m

  if (total > 0) {
    load_stage(0);
    if (resident)
      for (int s = 0; s < stages; ++s) load_centres(s, cbuf + s * kTC * kLd);
  }
  cp_async_commit();

  for (int gs = 0; gs < total; ++gs) {
    const int s = gs % stages;
    const int c0 = (s / nd) * kTC, ds = s % nd;
    if (gs + 1 < total) load_stage(gs + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // stage gs is in shared memory

    const float* ps = pbuf + (gs & 1) * kTP * kLd;
    const float* cs = cbuf + (resident ? s : gs & 1) * kTC * kLd;
    if (s == 0) {
      run_best = INFINITY;
      run_idx = 0;
      psq = 0.f;
    }
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < kRP; ++i)
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int m = 0; m < kCsq; ++m) csq[m] = 0.f;
    }
    if (tid < kTP && c0 == 0) {
#pragma unroll
      for (int q = 0; q < kTD / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ps + tid * kLd + 4 * q);
        psq = fmaf(v.x, v.x, psq);
        psq = fmaf(v.y, v.y, psq);
        psq = fmaf(v.z, v.z, psq);
        psq = fmaf(v.w, v.w, psq);
      }
    }
#pragma unroll
    for (int m = 0; m < kCsq; ++m) {
      const float* row = cs + (tid + kThreads * m) * kLd;
#pragma unroll
      for (int q = 0; q < kTD / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
        csq[m] = fmaf(v.x, v.x, csq[m]);
        csq[m] = fmaf(v.y, v.y, csq[m]);
        csq[m] = fmaf(v.z, v.z, csq[m]);
        csq[m] = fmaf(v.w, v.w, csq[m]);
      }
    }
#pragma unroll 2
    for (int q = 0; q < kTD / 4; ++q) {
      float4 b[kRC];
#pragma unroll
      for (int j = 0; j < kRC; ++j)
        b[j] = *reinterpret_cast<const float4*>(cs + (tx + 16 * j) * kLd + 4 * q);
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(ps + (ty + kTY * i) * kLd + 4 * q);
        // each acc an fmaf chain in ascending d; consecutive FMAs independent
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }

    if (ds == nd - 1) {  // the chunk's cross terms are complete
      if (tid < kTP && c0 == 0) psq_s[tid] = psq;
#pragma unroll
      for (int m = 0; m < kCsq; ++m) csq_s[tid + kThreads * m] = csq[m];
      __syncthreads();
      float best[kRP];
      int bi[kRP];
      if (c0 + kTC <= k)
        chunk_nearest<true>(acc, psq_s, csq_s, c0, k, tx, ty, best, bi);
      else
        chunk_nearest<false>(acc, psq_s, csq_s, c0, k, tx, ty, best, bi);
      // the 16 lanes holding each point: smallest d2, then smallest index
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
          if (ob < best[i] || (ob == best[i] && oi < bi[i])) {
            best[i] = ob;
            bi[i] = oi;
          }
        }
      }
      // a later chunk holds only larger indices: it wins only when strictly nearer
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (tx == i && best[i] < run_best) {
          run_best = best[i];
          run_idx = bi[i];
        }
      }
      if (s == stages - 1 && tx < kRP) {  // the tile is done
        const long long p = tile_p0(gs) + ty + kTY * tx;
        if (p < n) {
          assign[p] = run_idx;
          min_d2[p] = run_best;
        }
      }
    }
    __syncthreads();  // every reader of buffers gs & 1 is done before they are refilled
  }
}

// Slab layout, e = K*D + K + 1 floats: sums (K,D), counts (K,), cost; at
// the start of dynamic shared memory when kSmemSlab. Thread g * cols + t owns
// column cb + t of the sums of the centres c with c % groups == g, for each
// column pass cb (groups is a power of 2); thread g * cols also owns those
// centres' counts, and thread 0 the cost. The points pass through shared
// memory in tiles of kWalkTile points (the pass's columns, then each point's
// weight, d2 and centre), kWalkStages - 1 tiles ahead: with kVec a tile's
// points are bulk copies by the Tensor Memory Accelerator (one copy when the
// pass covers whole rows), issued by warp 0 and counted on the slot's
// mbarrier, else one cp.async a float; the weights, d2 and centres by
// cp.async. One barrier per tile. Lane r of each warp reads point r's weight
// and centre, one ballot marks the points of the warp's group, and the warp
// visits those in point order, loading each point's operands before it
// stores the previous point's sum.
template <bool kSmemSlab, bool kVec>
__global__ void __launch_bounds__(kWalkThreads)
partial_kernel(const float* __restrict__ points, const float* __restrict__ weights,
               const int* __restrict__ assign, const float* __restrict__ min_d2,
               int n, int d, int k, long long per, int cols, int groups,
               float* __restrict__ ws) {
  extern __shared__ float4 walk_smem4[];
  __shared__ unsigned long long bars[kWalkStages];
  float* smem = reinterpret_cast<float*>(walk_smem4);
  const long long e = (long long)k * d + k + 1;
  float* part = ws + (long long)blockIdx.x * e;
  float* slab = kSmemSlab ? smem : part;
  float* tiles = smem + (kSmemSlab ? (e + 3) / 4 * 4 : 0);
  const int tile_floats = kWalkTile * (cols + 3);
  const int tid = threadIdx.x, lane = tid & 31, nthreads = blockDim.x;
  const int g = tid / cols, t = tid - g * cols;  // cols % 32 == 0: one g per warp
  // a tile row's stride: D when one pass covers every column and the copy is
  // one bulk run, else the pass's cols
  const int xs = kVec && d <= cols ? d : cols;
  for (long long i = tid; i < e; i += nthreads) slab[i] = 0.f;
  if (kVec && tid == 0) {
    for (int b = 0; b < kWalkStages; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long start = (long long)blockIdx.x * per;
  const long long end = min((long long)n, start + per);
  const int ntiles = start < end ? (int)((end - start + kWalkTile - 1) / kWalkTile) : 0;
  float cost = 0.f;
  for (int cb = 0; cb < d; cb += cols) {
    const int col = cb + t;
    const int u0 = cb / cols * ntiles;  // the pass's first tile in the CTA's sequence
    // tile j: x (kWalkTile, cols), then w, d2 and the centre (as int bits);
    // past the range weights 0 (skipped); rows past the range and columns past
    // d are never read
    auto issue = [&](int j) {
      const int u = u0 + j;
      float* x = tiles + (u % kWalkStages) * tile_floats;
      const long long p0 = start + (long long)j * kWalkTile;
      if (kVec) {  // d % 4 == 0 and cb % 4 == 0: 16-byte rows
        if (tid < kWalkTile) {
          unsigned long long* bar = &bars[u % kWalkStages];
          const int rows = (int)min((long long)kWalkTile, end - p0);
          const unsigned row_bytes = (unsigned)min(cols, d - cb) * 4u;
          if (tid == 0) mbar_expect_bytes(bar, rows * row_bytes);
          __syncwarp();
          // the tile's earlier readers (generic proxy) before the copy's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (xs == d) {  // one pass: the tile's rows are one run of memory
            if (tid == 0) bulk_copy(x, points + p0 * d, rows * row_bytes, bar);
          } else if (tid < rows) {
            bulk_copy(x + tid * xs, points + (p0 + tid) * d + cb, row_bytes, bar);
          }
        }
      } else {  // row r = g + groups m, column t
        for (int r = g; r < kWalkTile; r += groups) {
          const bool ok = p0 + r < end && col < d;
          cp_async4(x + r * xs + t, ok ? points + (p0 + r) * d + col : points,
                    ok ? 4 : 0);
        }
      }
      if (tid < kWalkTile) {
        const bool ok = p0 + tid < end;
        float* meta = x + kWalkTile * cols;
        cp_async4(meta + tid, ok ? weights + p0 + tid : weights, ok ? 4 : 0);
        cp_async4(meta + kWalkTile + tid, ok ? min_d2 + p0 + tid : min_d2, ok ? 4 : 0);
        cp_async4(meta + 2 * kWalkTile + tid,
                  ok ? reinterpret_cast<const float*>(assign + p0 + tid)
                     : reinterpret_cast<const float*>(assign),
                  ok ? 4 : 0);
      }
    };
#pragma unroll
    for (int j = 0; j < kWalkStages - 1; ++j) {
      if (j < ntiles) issue(j);
      cp_async_commit();
    }
    for (int j = 0; j < ntiles; ++j) {
      const int u = u0 + j;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kWalkStages - 2));
      if (kVec) mbar_wait(&bars[u % kWalkStages], (unsigned)(u / kWalkStages) & 1u);
      __syncthreads();  // tile j is in; every reader of tile j - 1 is done
      if (j + kWalkStages - 1 < ntiles) issue(j + kWalkStages - 1);
      cp_async_commit();
      const float* x = tiles + (u % kWalkStages) * tile_floats;
      const float* w_s = x + kWalkTile * cols;
      const float* d_s = w_s + kWalkTile;
      const int* c_s = reinterpret_cast<const int*>(d_s + kWalkTile);
      if (cb == 0 && tid == 0) {  // the cost: every point of the part, in order
#pragma unroll
        for (int q = 0; q < kWalkTile / 4; ++q) {
          const float4 w4 = reinterpret_cast<const float4*>(w_s)[q];
          const float4 d4 = reinterpret_cast<const float4*>(d_s)[q];
          cost = w4.x != 0.f ? fmaf(d4.x, w4.x, cost) : cost;
          cost = w4.y != 0.f ? fmaf(d4.y, w4.y, cost) : cost;
          cost = w4.z != 0.f ? fmaf(d4.z, w4.z, cost) : cost;
          cost = w4.w != 0.f ? fmaf(d4.w, w4.w, cost) : cost;
        }
      }
      unsigned mine =
          __ballot_sync(0xffffffffu, w_s[lane] != 0.f && (c_s[lane] & (groups - 1)) == g);
      if (mine == 0u || col >= d) continue;  // no point of this group, or past column d
      int r = __ffs(mine) - 1;
      float w = w_s[r], xv = x[r * xs + t];
      int c = c_s[r];
      while (true) {  // ascending r: point order
        mine &= mine - 1;
        const int rn = mine ? __ffs(mine) - 1 : r;
        const float wn = w_s[rn], xn = x[rn * xs + t];
        const int cn = c_s[rn];
        float* s = slab + (long long)c * d + col;
        *s = fmaf(w, xv, *s);
        if (col == 0) slab[(long long)k * d + c] += w;
        if (mine == 0u) break;
        w = wn;
        xv = xn;
        c = cn;
      }
    }
    __syncthreads();  // every reader of the pass's tiles is done
  }
  if (tid == 0) slab[e - 1] = cost;
  if (kSmemSlab) {
    __syncthreads();
    for (long long i = tid; i < e; i += nthreads) part[i] = slab[i];
  }
}

// Dynamic shared memory past 48 KB, and the SM's largest shared carveout,
// so that the occupancy the sizes allow is the occupancy the card runs.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kSmemSlab, bool kVec>
cudaError_t launch_walk(const float* points, const float* weights, const int* assign,
                        const float* min_d2, int n, int d, int k, int parts, int cols,
                        int groups, size_t smem, float* ws, cudaStream_t s) {
  cudaError_t err = set_smem(partial_kernel<kSmemSlab, kVec>, smem);
  if (err != cudaSuccess) return err;
  const long long per = (n + (long long)parts - 1) / parts;
  partial_kernel<kSmemSlab, kVec><<<parts, cols * groups, smem, s>>>(
      points, weights, assign, min_d2, n, d, k, per, cols, groups, ws);
  return cudaGetLastError();
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

// points (n,d), weights (n,), centers (k,d) float32; the launch geometry of
// ops/kernels.kmeans_sweep_plan: tiles (assign CTAs), parts (walk CTAs),
// walk_cols x walk_groups walk threads, slab_in_smem; vector = 1 reads
// points and centres in 16-byte vectors (both 16-byte aligned, d % 4 == 0).
// Scratch assign (n,) int32, min_d2 (n,) and ws (parts, k*d+k+1) float32;
// out (k*d+k+1,) float32 receives sums, counts and cost. Returns a CUDA error
// code (0 = ok); a geometry this file cannot run is cudaErrorInvalidValue.
extern "C" int oryx_kmeans_assign(const float* points, const float* weights,
                                  const float* centers, int n, int d, int k,
                                  int tiles, int assign_ctas, int parts, int walk_cols,
                                  int walk_groups, int slab_in_smem, int vector,
                                  int* assign, float* min_d2, float* ws, float* out,
                                  void* stream) {
  const long long e = (long long)k * d + k + 1;
  const long long walk_tile_bytes =
      (long long)kWalkStages * kWalkTile * (walk_cols + 3) * sizeof(float);
  if (n <= 0 || d <= 0 || k <= 0 || parts <= 0 || tiles != (n + kTP - 1) / kTP ||
      assign_ctas < 1 || assign_ctas > tiles ||
      walk_cols < 32 || walk_cols % 32 != 0 || walk_groups < 1 ||
      (walk_groups & (walk_groups - 1)) != 0 ||
      walk_cols * walk_groups > kWalkThreads || walk_tile_bytes > kMaxSmemBytes ||
      (slab_in_smem && (e + 3) / 4 * 4 * 4 + walk_tile_bytes > kMaxSmemBytes))
    return (int)cudaErrorInvalidValue;
  if (vector && (reinterpret_cast<uintptr_t>(points) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(centers) % 16 != 0 || d % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err;
  if (vector) {
    err = set_smem(assign_kernel<true>, kAssignSmemBytes);
    if (err != cudaSuccess) return (int)err;
    assign_kernel<true><<<assign_ctas, kThreads, kAssignSmemBytes, s>>>(
        points, centers, n, d, k, tiles, assign, min_d2);
  } else {
    err = set_smem(assign_kernel<false>, kAssignSmemBytes);
    if (err != cudaSuccess) return (int)err;
    assign_kernel<false><<<assign_ctas, kThreads, kAssignSmemBytes, s>>>(
        points, centers, n, d, k, tiles, assign, min_d2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t tile_bytes = (size_t)walk_tile_bytes;
  const size_t smem = slab_in_smem ? (size_t)(e + 3) / 4 * 4 * sizeof(float) + tile_bytes
                                   : tile_bytes;
  auto walk = slab_in_smem ? (vector ? launch_walk<true, true> : launch_walk<true, false>)
                           : (vector ? launch_walk<false, true> : launch_walk<false, false>);
  err = walk(points, weights, assign, min_d2, n, d, k, parts, walk_cols, walk_groups, smem,
             ws, s);
  if (err != cudaSuccess) return (int)err;

  const int blocks = (int)((e + 127) / 128);
  reduce_kernel<<<blocks, 128, 0, s>>>(ws, parts, e, out);
  return (int)cudaGetLastError();
}
