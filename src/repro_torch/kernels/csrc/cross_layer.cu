// DCN-v2 cross layer, forward:  out = x0 * (x @ W + b) + x,
// with x0, x [B, d], W [d, d], b [d], all float32 and row-major.
//
// Replaces cross_layer_pallas (src/repro/kernels/cross_layer.py:30).
//
// Bound: operations. 2*B*d^2 flops against 3*B*d + d^2 floats moved (at
// d = 429, about 140 flops a byte at any B), on the float32 units: no
// tensor cores, so the result keeps float32 precision. The TPU kernel pads
// the batch to 128 and d to 512 and tiles (batch x out-dim) with the full
// x row in VMEM and the matmul on the MXU. Here a block computes a 64 x 64
// tile of x @ W through 32-wide shared-memory slabs (cross_tile.cuh), the
// next slab's loads in flight while it computes on this one, each thread a
// 4 x 4 patch in registers, and applies the epilogue
// x0 * (acc + b) + x to its patch before it stores it, so the [B, d]
// product never goes to device memory. Edge tiles load zeros past B and d:
// no padded copies. At layer 0 x and x0 are one tensor; both are only
// read. The epilogue rounds each step on its own (no FMA contraction), in
// the reference's order.
#include <cstdint>
#include <cuda_runtime.h>

#include "cross_tile.cuh"

namespace {

using namespace cross;

__global__ void __launch_bounds__(kThreads)
cross_layer_kernel(const float* x0, const float* x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out, int64_t bsz,
                   int d) {
  __shared__ __align__(16) Tile xs;
  __shared__ __align__(16) Tile ws;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tr = threadIdx.x / (kBN / kTN), tc = threadIdx.x % (kBN / kTN);
  float acc[kTM][kTN] = {};
  Frag fx, fw;
  fetch_t(fx, x, nullptr, bsz, d, row0, 0);
  fetch_n(fw, w, nullptr, d, d, 0, col0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    store_t(xs, fx);  // xs[k][r] = x[row0 + r][k0 + k]
    store_n(ws, fw);  // ws[k][c] = W[k0 + k][col0 + c]
    __syncthreads();
    if (k0 + kBK < d) {  // the next slab's loads fly while this one is used
      fetch_t(fx, x, nullptr, bsz, d, row0, k0 + kBK);
      fetch_n(fw, w, nullptr, d, d, k0 + kBK, col0);
    }
    mma(xs, ws, acc, tr, tc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + tr * kTM + i;
    if (r >= bsz) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tc * kTN + j;
      if (c < d) {
        const int64_t e = r * d + c;
        out[e] = __fadd_rn(__fmul_rn(x0[e], __fadd_rn(acc[i][j], b[c])), x[e]);
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int cross_layer_launch(const void* x0, const void* x, const void* w,
                                  const void* b, void* out, int64_t bsz, int d,
                                  void* stream) {
  const dim3 grid(static_cast<unsigned int>((bsz + kBM - 1) / kBM),
                  static_cast<unsigned int>((d + kBN - 1) / kBN));
  cross_layer_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), bsz, d);
  return static_cast<int>(cudaGetLastError());
}
