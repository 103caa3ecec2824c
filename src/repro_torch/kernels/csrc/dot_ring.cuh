// The persistent cp.async ring that both DLRM dot kernels run
// (dot_interaction.cu and dot_interaction_bwd.cu): the copy helpers, the
// walk of a block's groups of samples through `kStages` shared-memory
// buffers, and the host side that sizes the persistent grid.
//
// A block takes groups blockIdx.x, blockIdx.x + gridDim.x, ... (the grid is
// what fits on the card at once). Before group `it` is computed, the copies
// of groups it + 1 .. it + kStages - 1 are in flight, so device memory is
// read while the block computes.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace dot_ring {

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int up4(int v) { return (v + 3) & ~3; }

// Groups of `spb` samples this block walks: blockIdx.x + it * gridDim.x for
// it < block_iters(...).
__device__ __forceinline__ int64_t block_iters(int64_t b, int spb) {
  const int64_t groups = (b + spb - 1) / spb;
  return blockIdx.x < groups ? (groups - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
}

__device__ __forceinline__ int64_t first_sample(int64_t it, int spb) {
  return (blockIdx.x + it * gridDim.x) * spb;
}

// Runs `load(it)` (the cp.async copies of group it into buffer it % kStages;
// it must return at once for it >= n_it) ahead of `body(it)`. On entry to
// body(it) group it's copies are visible to every thread, and every thread
// is done with body(it - 1), so whatever body(it - 1) read of shared memory
// besides this group's buffer is free again.
template <int kStages, class Load, class Body>
__device__ __forceinline__ void walk(int64_t n_it, Load load, Body body) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s);
    commit();  // an empty group keeps the wait count uniform
  }
  for (int64_t it = 0; it < n_it; ++it) {
    wait_groups<kStages - 2>();
    __syncthreads();
    load(it + kStages - 1);
    commit();
    body(it);
  }
}

// The opt-in above 48 KB and the blocks an SM holds, for the last (device,
// threads, smem) of one kernel, so a step's launch repeats no host query.
struct LaunchCache {
  int dev = -1, threads = 0, sms = 0, per_sm = 0;
  size_t smem = 0;
};

// The persistent grid of `kern` for `groups` groups: no more blocks than
// groups, nor than the card holds at once.
template <class Kernel>
cudaError_t persistent_grid(Kernel kern, int threads, size_t smem, int64_t groups,
                            LaunchCache& c, int64_t* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != c.dev || threads != c.threads || smem != c.smem) {
    c.dev = -1;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kern, threads,
                                                             smem)) != cudaSuccess)
      return err;
    if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
    c.dev = dev;
    c.threads = threads;
    c.smem = smem;
  }
  const int64_t resident = static_cast<int64_t>(c.sms) * c.per_sm;
  *grid = groups < resident ? groups : resident;
  return cudaSuccess;
}

}  // namespace dot_ring
