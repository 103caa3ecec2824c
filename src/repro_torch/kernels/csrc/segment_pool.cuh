// Device code of the forward SegmentReduction, gather_pool.cu, whose CSR
// pass gather_project_grad.cu also runs (the TPU's embedding_bag_pallas,
// src/repro/kernels/embedding_bag.py:41, beneath gather_pool_pallas).
//
// It computes out[o] = sum over positions p of segment o, in ascending
// order, of w[p] * src[gather[p]], with the segment ids `seg` sorted:
//   1. csr_offsets: one thread per position writes the CSR start of every
//      output segment that begins there, and one thread per output segment
//      past the last position's writes n there (offsets[n_out] = n). A
//      transpose's unused slots are such a tail, n - n_uniq long: a
//      single thread walking it was 5.9 ms of a 2.6 M-position call;
//   2. pool: one thread per (output row, d) element adds its segment's
//      positions in order in a register and writes the element once.
//      Threads of a block are laid out (d, row), so neighbouring threads
//      take neighbouring d of one row: source reads and output writes are
//      contiguous, and no thread divides to find its row.
// Every output row is written, so a row with no position comes out exactly
// 0 without ghost positions, and no [n, D] per-position array exists. No
// atomics: the sum order is fixed.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace segment_pool {

constexpr int kThreads = 256;

// Segments in (seg[i-1], seg[i]] start at position i (seg[-1] = -1);
// segments in (seg[n-1], n_out] start at n. Thread t does both jobs for
// position t and segment t, so the grid covers max(n, n_out + 1) threads.
// A gap between two positions' segments is still walked by one thread;
// the packed layouts leave no such gaps.
__global__ void csr_offsets_kernel(const int32_t* __restrict__ seg,
                                   int32_t* __restrict__ offsets, int32_t n,
                                   int32_t n_out) {
  const int32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t < n) {
    const int32_t prev = t == 0 ? -1 : seg[t - 1];
    // clamped so a seg value outside [0, n_out) never writes out of
    // bounds; such positions fall outside every segment, as in the
    // reference's segment_sum
    const int32_t cur = seg[t];
    const int32_t hi = cur < n_out ? cur : n_out;
    for (int32_t b = prev + 1 > 0 ? prev + 1 : 0; b <= hi; ++b) offsets[b] = t;
  }
  const int32_t last = n > 0 ? seg[n - 1] : -1;
  if (t <= n_out && t > last) offsets[t] = n;
}

__global__ void pool_kernel(const float* __restrict__ src,
                            const int32_t* __restrict__ gather,
                            const float* __restrict__ w,
                            const int32_t* __restrict__ offsets,
                            float* __restrict__ out, int32_t n_out, int32_t d) {
  const int32_t o = blockIdx.x * blockDim.y + threadIdx.y;
  const int32_t c = threadIdx.x;
  if (o >= n_out) return;
  const int32_t end = offsets[o + 1];
  float acc = 0.0f;
  for (int32_t i = offsets[o]; i < end; ++i) {
    // __fmul_rn keeps the product rounded on its own (no FMA contraction),
    // as in the reference's multiply-then-sum.
    acc += __fmul_rn(w[i], src[static_cast<int64_t>(gather[i]) * d + c]);
  }
  out[static_cast<int64_t>(o) * d + c] = acc;
}

// Launches both passes on `stream`; `offsets` is int32 scratch of n_out + 1.
// Needs n, n_out < 2^31 and 0 < d <= 1024 (the wrappers check). Returns
// cudaGetLastError() so the caller can raise.
inline int launch(const float* src, const int32_t* gather, const float* w,
                  const int32_t* seg, int32_t* offsets, float* out, int64_t n,
                  int64_t n_out, int d, cudaStream_t s) {
  const int32_t n32 = static_cast<int32_t>(n), no32 = static_cast<int32_t>(n_out);
  const int64_t threads = n > n_out + 1 ? n : n_out + 1;
  csr_offsets_kernel<<<static_cast<unsigned int>((threads + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(seg, offsets, n32, no32);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows_per_block = d >= kThreads ? 1 : kThreads / d;
  const dim3 block(d, rows_per_block);
  const unsigned int blocks =
      static_cast<unsigned int>((n_out + rows_per_block - 1) / rows_per_block);
  pool_kernel<<<blocks, block, 0, s>>>(src, gather, w, offsets, out, no32, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segment_pool
