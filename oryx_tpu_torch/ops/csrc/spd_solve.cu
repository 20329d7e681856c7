// Batched Gauss-Jordan solve of small regularised SPD systems, by hand for
// Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_spd_solve_kernel`
// (oryx_tpu/ops/pallas_kernels.py:89-116, entry spd_solve_batched :162-194),
// which the reference trainer calls from train._solve_block for the per-row
// normal equations A x = b.
//
// Computes x[s] = A[s]^-1 b[s] for every system s by Gauss-Jordan elimination
// without pivoting, in the reference's order: for each j, normalise pivot
// row j, then eliminate column j from every other row. No pivoting is safe
// because the trainer's systems are SPD with a diagonal shift >= lambda.
// Only the live columns j+1..k are updated at step j: column j is never
// read again. A is read as stored, row by row (the trainer's Gramians are
// not bitwise symmetric).
//
// What bounds it on this card: neither bytes nor flops but latency. The
// algorithm needs ~k^3 flops and 4*(k^2 + 2k) bytes per system (at k = 50 on
// a 7.7k-row block: ~1 GFLOP and ~80 MB, a ~24 us memory floor), yet each
// elimination step depends on the previous one: a system is k dependent
// rounds of a few flops per row.
//
// Two kernels, chosen by k in oryx_spd_solve:
//
// * k <= 64 (the trainer's usual widths): spd_solve_warp_kernel, one warp per
//   system with the augmented rows in registers. Lane l owns row l and, for
//   k > 32, row l + 32; each owned row of A is a register array of
//   compile-time length KP, with b held apart. KP is k rounded up to a
//   multiple of 4 (one template per width, so at most 3 zero columns ride
//   along). The step and column loops are unrolled (the step loop by
//   template recursion), so every register index is a compile-time constant
//   and nothing goes to local memory.
//
//   Step j: the owner lane j % 32 holds the pivot row in its slot j / 32.
//   Every lane takes the pivot and the live entries j+1..k of that row by
//   __shfl_sync, takes one IEEE reciprocal of the pivot (no per-element
//   division), and updates its own rows with one FMA per entry,
//   row[c] -= (row[j] / pivot) * pivot_row[c]. The pivot row is not
//   rescaled: its lane keeps 1 / pivot, and x[j] = b[j] * (1 / pivot) at the
//   end is the normalised pivot row's b entry, one multiply per step in
//   place of one per entry. Columns are guarded in groups of 16 (columns
//   past k are zero in every row and stay zero): a group's shuffles are in
//   flight together, and the guard bounds how far the compiler hoists them
//   (unguarded, KP = 64 needs far more registers). No block barrier and no
//   index arithmetic at run time. Rows past k (lanes >= k, or slot 1 with
//   l + 32 >= k) are zero, never pivot, and are never written to x.
//
//   Loads: each warp stages its system's A through its own slice of shared
//   memory, row by row with consecutive lanes on consecutive addresses
//   (coalesced; the row loop is unrolled and predicated so the loads are in
//   flight together), at an odd row stride so that lane l's reads of row l
//   hit 32 different banks. Reading each lane's row straight from device
//   memory would touch 32 cache lines per load instruction. b is read and x
//   written directly, one row per lane. Two warps (two systems) per CTA; a
//   warp past the batch returns at once, and nothing waits on a block-wide
//   barrier.
//
//   What bounds it: shuffle throughput, ~k^2/2 warp shuffles (~1,300 at
//   k = 50, beside ~2,600 FMAs per lane) at one warp shuffle per clock per
//   SM. What holds it above that: registers (128 at KP = 52, 16 warps per SM)
//   leave few warps to hide each step's dependent chain of pivot shuffle,
//   reciprocal and factors. PERF.md has the times and register counts.
// * 64 < k <= 240: spd_solve_kernel, one 256-thread CTA per system with the
//   augmented k x (k+1) matrix in dynamic shared memory (~10 KB at k = 50,
//   ~227 KB at k = 240), three barriers per step. Above 48 KB the launch
//   raises the kernel's dynamic shared-memory limit; the wrapper sends k
//   whose matrix does not fit the 227 KB a block can use (k > 240) to a
//   Cholesky solve instead. That gate is not the reference's (~297, from its
//   VMEM budget): it comes from this card's shared memory.
//
// Neither kernel pads the batch, and B = 0 launches nothing. The crossover
// kWarpMaxK is read by the Python wrapper through oryx_spd_warp_max_k, so
// the launch it counts is the one made here; oryx_spd_solve_cta runs the CTA
// kernel at any k <= 240, for timing the two kernels on the same systems.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerCta = 2;  // warp kernel: systems per CTA
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGroup = 16;      // warp kernel: columns per run-time guard
constexpr int kWidthStep = 4;  // warp kernel: KP is k rounded up to this
constexpr int kWarpMaxK = 64;
// a warp's staging slice, k x (k | 1) floats, fits the default 48 KB per CTA
static_assert(kWarpsPerCta * kWarpMaxK * (kWarpMaxK + 1) * 4 <= 48 * 1024, "");

__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ x, int k) {
  extern __shared__ float smem[];
  const int ld = k + 1;
  float* aug = smem;           // k x (k+1), row-major, [A | b]
  float* fac = smem + k * ld;  // column j of aug at the start of step j
  const size_t sys = blockIdx.x;
  const float* as = a + sys * k * k;
  const float* bs = b + sys * k;
  for (int idx = threadIdx.x; idx < k * k; idx += kThreads)
    aug[(idx / k) * ld + idx % k] = as[idx];
  for (int i = threadIdx.x; i < k; i += kThreads) aug[i * ld + k] = bs[i];
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const float piv = aug[j * ld + j];
    for (int i = threadIdx.x; i < k; i += kThreads) fac[i] = aug[i * ld + j];
    __syncthreads();
    const int width = k - j;  // live columns j+1 .. k
    for (int c = threadIdx.x; c < width; c += kThreads)
      aug[j * ld + j + 1 + c] /= piv;
    __syncthreads();
    for (int idx = threadIdx.x; idx < k * width; idx += kThreads) {
      const int i = idx / width;
      const int c = j + 1 + idx % width;
      if (i != j) aug[i * ld + c] -= fac[i] * aug[j * ld + c];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < k; i += kThreads) x[sys * k + i] = aug[i * ld + k];
}

// Elimination step J of the warp kernel, then steps J+1.. by recursion: J is
// a template constant, so row[J / 32][J] and the unrolled columns c are
// compile-time register indices. The pivot row is left as it is: every
// other row takes fac = row[J] / pivot (one multiply by the reciprocal per
// row) and row[c] -= fac * pivot_row[c], and the pivot lane keeps the
// reciprocal for its row, so x[J] = b[J] * (1 / pivot) at the end. Columns
// go in groups of kGroup with one run-time guard per group, so a group's
// shuffles are in flight together; columns past k are zero in every row and
// come out zero.
template <int KP, int NS, int J>
__device__ __forceinline__ void warp_steps(float (&row)[NS][KP], float (&rb)[NS],
                                           float (&dinv)[NS], int k, int lane) {
  if constexpr (J < KP) {
    if (J >= k) return;
    constexpr int kOwner = J % 32;
    constexpr int kSlot = J / 32;
    const bool pivot_lane = lane == kOwner;
    const float inv = __frcp_rn(__shfl_sync(kFullMask, row[kSlot][J], kOwner));
    float fac[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) fac[s] = row[s][J] * inv;
    if (pivot_lane) {
      fac[kSlot] = 0.0f;  // the pivot row itself stays as it is
      dinv[kSlot] = inv;
    }
#pragma unroll
    for (int c0 = (J + 1) / kGroup * kGroup; c0 < KP; c0 += kGroup) {
      if (c0 >= k) break;
#pragma unroll
      for (int c = c0; c < c0 + kGroup && c < KP; ++c) {
        if (c <= J) continue;
        const float pc = __shfl_sync(kFullMask, row[kSlot][c], kOwner);
#pragma unroll
        for (int s = 0; s < NS; ++s) row[s][c] = fmaf(-fac[s], pc, row[s][c]);
      }
    }
    const float pb = __shfl_sync(kFullMask, rb[kSlot], kOwner);
#pragma unroll
    for (int s = 0; s < NS; ++s) rb[s] = fmaf(-fac[s], pb, rb[s]);
    warp_steps<KP, NS, J + 1>(row, rb, dinv, k, lane);
  }
}

template <int KP>
__global__ void __launch_bounds__(32 * kWarpsPerCta, 1)
spd_solve_warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ x, int batch, int k) {
  constexpr int NS = (KP + 31) / 32;  // rows per lane
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long sys = (long long)blockIdx.x * kWarpsPerCta + warp;
  if (sys >= batch) return;
  const int ld = k | 1;  // odd stride: row `lane` reads are conflict-free
  float* stage = smem + warp * k * ld;
  const float* as = a + sys * k * k;
  // unrolled and predicated, so every row's loads are in flight together
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    if (r < k) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int c = lane + 32 * s;
        if (c < k) stage[r * ld + c] = as[r * k + c];
      }
    }
  }
  __syncwarp();

  float row[NS][KP];
  float rb[NS];
  float dinv[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = lane + 32 * s;
    const bool live = r < k;
#pragma unroll
    for (int c = 0; c < KP; ++c)
      row[s][c] = (live && c < k) ? stage[r * ld + c] : 0.0f;
    rb[s] = live ? b[sys * k + r] : 0.0f;
    dinv[s] = 0.0f;
  }

  warp_steps<KP, NS, 0>(row, rb, dinv, k, lane);

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int r = lane + 32 * s;
    if (r < k) x[sys * k + r] = rb[s] * dinv[s];
  }
}

template <int KP>
cudaError_t launch_warp(const float* a, const float* b, float* x, int batch, int k,
                        cudaStream_t stream) {
  const size_t smem = (size_t)kWarpsPerCta * k * (k | 1) * sizeof(float);
  const int ctas = (batch + kWarpsPerCta - 1) / kWarpsPerCta;
  spd_solve_warp_kernel<KP><<<ctas, 32 * kWarpsPerCta, smem, stream>>>(a, b, x, batch, k);
  return cudaGetLastError();
}

// The warp kernel for the smallest KP >= k among kWidthStep, 2 kWidthStep, ..
// kWarpMaxK: at most kWidthStep - 1 zero columns per row.
template <int KP>
cudaError_t launch_fit(const float* a, const float* b, float* x, int batch, int k,
                       cudaStream_t stream) {
  if constexpr (KP < kWarpMaxK) {
    if (k > KP) return launch_fit<KP + kWidthStep>(a, b, x, batch, k, stream);
  }
  return launch_warp<KP>(a, b, x, batch, k, stream);
}

cudaError_t launch_cta(const float* a, const float* b, float* x, int batch, int k,
                       cudaStream_t stream) {
  const size_t smem = (size_t)k * (k + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  spd_solve_kernel<<<batch, kThreads, smem, stream>>>(a, b, x, k);
  return cudaGetLastError();
}

}  // namespace

// a: (batch, k, k), b: (batch, k), x: (batch, k), all float32 and
// contiguous. Returns the cudaError_t of the launch (or of raising the
// shared-memory limit).
extern "C" int oryx_spd_solve(const float* a, const float* b, float* x, int batch,
                              int k, void* stream) {
  if (batch <= 0 || k <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kWarpMaxK) return (int)launch_fit<kWidthStep>(a, b, x, batch, k, s);
  return (int)launch_cta(a, b, x, batch, k, s);
}

// The CTA kernel at any k <= 240, with oryx_spd_solve's arguments.
extern "C" int oryx_spd_solve_cta(const float* a, const float* b, float* x,
                                  int batch, int k, void* stream) {
  if (batch <= 0 || k <= 0) return (int)cudaSuccess;
  return (int)launch_cta(a, b, x, batch, k, static_cast<cudaStream_t>(stream));
}

// The largest k that oryx_spd_solve sends to the warp kernel.
extern "C" int oryx_spd_warp_max_k() { return kWarpMaxK; }
