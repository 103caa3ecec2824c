// Fused gather + pool (forward SegmentReduction) over the unique rows.
//
// Replaces gather_pool_pallas (src/repro/kernels/fused_embedding.py:81) and
// embedding_bag_pallas (src/repro/kernels/embedding_bag.py:41) beneath it:
//   bags[seg[i]] += w[i] * rows_u[inv[i]],  seg sorted ascending.
//
// Bound: bytes. Per position it reads inv, w, seg and one D-float row, and
// per bag it writes D floats; two flops per element. The TPU kernel walks
// positions on a sequential grid and keeps one bag block in VMEM while its
// segment lasts, with one zero-weight ghost position per bag merged in (an
// extra argsort) so that an uncovered bag is written at all. Hopper blocks
// run in parallel and in no order, so the work is split in two passes:
//   1. csr_offsets: one thread per position boundary writes the CSR start
//      of every bag that begins there (offsets[n_bags] = n), O(n + n_bags);
//   2. pool: one thread per (bag, d) output element adds its bag's
//      positions in ascending order in a register and writes the element
//      once. Threads of a block are laid out (d, bag), so neighbouring
//      threads take neighbouring d of one row: row reads and bag writes are
//      contiguous, and no thread divides to find its bag.
// Every bag is written, so a bag with no position comes out exactly 0
// without ghosts, and the [n, D] per-id array never exists. No atomics:
// the sum order is fixed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Bags in (seg[i-1], seg[i]] start at position i (seg[-1] = -1, seg[n] = n_bags).
__global__ void csr_offsets_kernel(const int32_t* __restrict__ seg,
                                   int32_t* __restrict__ offsets, int32_t n,
                                   int32_t n_bags) {
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i > n) return;
  const int32_t prev = i == 0 ? -1 : seg[i - 1];
  const int32_t cur = i == n ? n_bags : seg[i];
  // clamped so a seg value outside [0, n_bags) never writes out of bounds;
  // such positions fall outside every bag, as in the reference's segment_sum
  const int32_t hi = cur < n_bags ? cur : n_bags;
  for (int32_t b = prev + 1 > 0 ? prev + 1 : 0; b <= hi; ++b) offsets[b] = i;
}

__global__ void pool_kernel(const float* __restrict__ rows_u,
                            const int32_t* __restrict__ inv,
                            const float* __restrict__ w,
                            const int32_t* __restrict__ offsets,
                            float* __restrict__ out, int32_t n_bags, int32_t d) {
  const int32_t bag = blockIdx.x * blockDim.y + threadIdx.y;
  const int32_t c = threadIdx.x;
  if (bag >= n_bags) return;
  const int32_t end = offsets[bag + 1];
  float acc = 0.0f;
  for (int32_t i = offsets[bag]; i < end; ++i) {
    // __fmul_rn keeps the product rounded on its own (no FMA contraction),
    // as in the reference's multiply-then-sum.
    acc += __fmul_rn(w[i], rows_u[static_cast<int64_t>(inv[i]) * d + c]);
  }
  out[static_cast<int64_t>(bag) * d + c] = acc;
}

}  // namespace

// Launches both passes on `stream`; `offsets` is int32 scratch of n_bags + 1.
// Needs n, n_bags < 2^31 and 0 < d <= 1024 (the wrapper checks). Returns
// cudaGetLastError() so the caller can raise.
extern "C" int gather_pool_launch(const void* rows_u, const void* inv,
                                  const void* w, const void* seg, void* offsets,
                                  void* out, int64_t n, int64_t n_bags, int d,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t n32 = static_cast<int32_t>(n), nb32 = static_cast<int32_t>(n_bags);
  csr_offsets_kernel<<<static_cast<unsigned int>((n + kThreads) / kThreads), kThreads, 0,
                       s>>>(static_cast<const int32_t*>(seg),
                            static_cast<int32_t*>(offsets), n32, nb32);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int bags_per_block = d >= kThreads ? 1 : kThreads / d;
  const dim3 block(d, bags_per_block);
  const unsigned int blocks =
      static_cast<unsigned int>((n_bags + bags_per_block - 1) / bags_per_block);
  pool_kernel<<<blocks, block, 0, s>>>(
      static_cast<const float*>(rows_u), static_cast<const int32_t*>(inv),
      static_cast<const float*>(w), static_cast<const int32_t*>(offsets),
      static_cast<float*>(out), nb32, d);
  return static_cast<int>(cudaGetLastError());
}
