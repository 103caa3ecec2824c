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
// run in parallel and in no order, so the work is split in two passes, a
// CSR pass and a pool pass (segment_pool.cuh):
// every bag is written, so a bag with no position comes out exactly 0
// without ghosts, the [n, D] per-id array never exists, and there are no
// atomics.
#include "segment_pool.cuh"

// Launches both passes on `stream`; `offsets` is int32 scratch of n_bags + 1.
// Needs n, n_bags < 2^31 and 0 < d <= 1024 (the wrapper checks). Returns
// cudaGetLastError() so the caller can raise.
extern "C" int gather_pool_launch(const void* rows_u, const void* inv,
                                  const void* w, const void* seg, void* offsets,
                                  void* out, int64_t n, int64_t n_bags, int d,
                                  void* stream) {
  return segment_pool::launch(
      static_cast<const float*>(rows_u), static_cast<const int32_t*>(inv),
      static_cast<const float*>(w), static_cast<const int32_t*>(seg),
      static_cast<int32_t*>(offsets), static_cast<float*>(out), n, n_bags, d,
      static_cast<cudaStream_t>(stream));
}
