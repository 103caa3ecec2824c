// Dedup + row-wise Adagrad, in place on the table and its accumulator.
//
// Replaces dedup_adagrad_pallas (src/repro/kernels/fused_embedding.py:194).
// For every distinct valid destination row r of the m gradient rows:
//   gsum = sum_{idx[j] = r} g[j]          (in stable-sorted position order)
//   acc[r] += mean_d(gsum^2);  w[r] -= lr * gsum / sqrt(acc[r] + eps)
//
// Bound: bytes. It reads the m sorted indices, their order and the m
// D-float gradient rows once, and reads and writes each touched row of w
// and acc once; a handful of flops per element. The TPU kernel walks the
// sorted positions on a sequential grid, carries the run's sum in VMEM and
// DMAs the row in and out at the run's last step, after its wrapper has
// gathered the m gradient rows into sorted order ([m, D] copy). Here one
// warp takes one sorted position; a warp whose position starts a run walks
// the run in sorted order, summing g[order[j]] with its lanes over D (no
// gathered copy), reduces mean(gsum^2) by a warp shuffle, and updates its
// row of w and acc in place. Runs are distinct rows, so no two warps write
// one row: no atomics, and the rows no run touches are never read or
// written, so they stay bitwise unchanged. The sentinel run (invalid
// entries, index == rows) and any index outside [0, rows) are dropped, so
// the kernel never writes outside the table. The arithmetic uses
// round-to-nearest intrinsics, so no FMA contraction reorders it: the
// reference's multiply, divide and sqrt each round once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPerLane = 4;  // D <= 32 * kMaxPerLane = 128

__global__ void dedup_adagrad_kernel(float* __restrict__ w, float* __restrict__ acc,
                                     const int32_t* __restrict__ si,
                                     const int64_t* __restrict__ order,
                                     const float* __restrict__ g, int64_t m,
                                     int64_t rows, int d, float lr, float eps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= m) return;  // the whole warp leaves together
  const int32_t row = si[i];
  if (row < 0 || row >= rows) return;         // sentinel / out-of-range run
  if (i > 0 && si[i - 1] == row) return;      // not the first of its run
  float gs[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) gs[k] = 0.0f;
  for (int64_t j = i; j < m && si[j] == row; ++j) {
    const float* gj = g + order[j] * d;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < d) gs[k] += gj[c];
    }
  }
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < d) sq += __fmul_rn(gs[k], gs[k]);
  }
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  float* wr = w + static_cast<int64_t>(row) * d;
  const float a = __fadd_rn(acc[row], __fdiv_rn(sq, static_cast<float>(d)));
  const float denom = __fsqrt_rn(__fadd_rn(a, eps));
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < d) wr[c] = __fsub_rn(wr[c], __fdiv_rn(__fmul_rn(lr, gs[k]), denom));
  }
  if (lane == 0) acc[row] = a;
}

}  // namespace

// `si` is the [m] int32 destination rows sorted ascending (invalid entries
// set to `rows` first, so they sort last) and `order` the stable sort's
// int64 permutation. Updates w [rows, d] and acc [rows, 1] in place on
// `stream`. Needs 0 < d <= 128 and rows < 2^31 (the wrapper checks).
// Returns cudaGetLastError() so the caller can raise.
extern "C" int dedup_adagrad_launch(void* w, void* acc, const void* si,
                                    const void* order, const void* g, int64_t m,
                                    int64_t rows, int d, float lr, float eps,
                                    void* stream) {
  const int64_t blocks = (m + kWarps - 1) / kWarps;
  dedup_adagrad_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<float*>(acc),
      static_cast<const int32_t*>(si), static_cast<const int64_t*>(order),
      static_cast<const float*>(g), m, rows, d, lr, eps);
  return static_cast<int>(cudaGetLastError());
}
