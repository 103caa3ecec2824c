// Segment-grad: the transpose of gather_pool onto the unique-row slots,
//   g_rows[u] = sum_{inv[i] = u} w[i] * g_bags[seg[i]],  for u < n_rows.
//
// Replaces segment_grad_pallas (src/repro/kernels/fused_embedding.py:111),
// which reaches pallas_call through embedding_bag_pallas
// (src/repro/kernels/embedding_bag.py:60).
//
// Bound: bytes. Per position it reads seg, w, the sort's order and one
// D-float bag gradient; per slot it writes D floats; two flops per element.
// `inv` is not sorted. The TPU wrapper argsorts the positions by slot with
// n_rows zero-weight ghosts merged in, so every slot is visited on its
// sequential grid. Here the wrapper sorts the positions by slot once
// (stable, so a slot's contributions are added in original position order,
// the reference segment_sum's order) and this kernel runs the same CSR +
// pool passes as gather_pool (segment_pool.cuh), reading each position
// through the sort's order: no ghosts, no gathered copies of seg and w, no
// [n, D] per-position array and no atomics. Slots that no position maps to
// (>= n_uniq) come out exactly 0.
#include "segment_pool.cuh"

// `sorted_inv` is inv sorted ascending and `order` (int64) the stable sort's
// permutation; `offsets` is int32 scratch of n_rows + 1. Needs n, n_rows <
// 2^31 and 0 < d <= 1024 (the wrapper checks). Returns cudaGetLastError()
// so the caller can raise.
extern "C" int segment_grad_launch(const void* g_bags, const void* seg,
                                   const void* w, const void* order,
                                   const void* sorted_inv, void* offsets,
                                   void* out, int64_t n, int64_t n_rows, int d,
                                   void* stream) {
  return segment_pool::launch<true>(
      static_cast<const float*>(g_bags), static_cast<const int32_t*>(seg),
      static_cast<const float*>(w), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(sorted_inv), static_cast<int32_t*>(offsets),
      static_cast<float*>(out), n, n_rows, d, static_cast<cudaStream_t>(stream));
}
