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
//
// What bounds it on this card: neither bytes nor flops but latency. The
// algorithm needs ~k^3 flops and 4*(k^2 + 2k) bytes per system (at k = 50 on
// a 7.7k-row block: ~1 GFLOP and ~80 MB, a ~24 us memory floor), yet each
// elimination step depends on the previous one, so a system is k dependent
// rounds of a few flops per thread, each closed by a barrier.
//
// Design. One CTA per system (grid = batch, so no batch padding is needed
// and B = 0 launches nothing): the augmented k x (k+1) matrix lives in
// dynamic shared memory, loaded once from device memory and solved in place;
// only x goes back. Each step updates only the columns still live (j+1..k),
// so step j touches k*(k-j) values. At k = 50 a CTA holds ~10 KB of shared
// memory, so many systems run on each SM at once and hide the barriers of
// one another. Above 48 KB the launch raises the kernel's dynamic
// shared-memory limit; the wrapper sends k whose matrix does not fit the
// 227 KB a block can use (k > 240) to a Cholesky solve instead. That gate
// is not the reference's (~297, from its VMEM budget): it comes from this
// card's shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

}  // namespace

// a: (batch, k, k), b: (batch, k), x: (batch, k), all float32 and
// contiguous. Returns the cudaError_t of the launch (or of raising the
// shared-memory limit).
extern "C" int oryx_spd_solve(const float* a, const float* b, float* x, int batch,
                              int k, void* stream) {
  if (batch <= 0 || k <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)k * (k + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spd_solve_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, x, k);
  return (int)cudaGetLastError();
}
