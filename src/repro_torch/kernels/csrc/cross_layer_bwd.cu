// DCN-v2 cross layer, backward: from x0, x [B, d], W [d, d], b [d] and the
// cotangent g [B, d] of out = x0 * (x @ W + b) + x,
//   gz  = g * x0                 (never stored)
//   gx0 = g * (x @ W + b)        (z recomputed)
//   gx  = gz @ W^T + g
//   gW  = x^T @ gz,  gb = sum_B gz.
//
// Replaces cross_layer_bwd_pallas (src/repro/kernels/interaction_bwd.py:147).
//
// Bound: operations, 6*B*d^2 flops (three GEMMs) on the float32 units. The
// TPU kernel walks batch tiles on a sequential grid and carries gW and gb
// across grid steps in its output blocks. Hopper's blocks run in no order,
// so the work is three kernels on one stream:
//   1. dx: a block per 64 x 64 tile of [B, d] runs the two GEMMs that share
//      its rows, x @ W and gz @ W^T, through one loop over 32-wide slabs
//      (gz = g * x0 formed as it is loaded, the next slab's loads in flight
//      while this one is used), and writes gx0 and gx;
//   2. dw: split-K over the batch. The batch is cut into `splits` chunks of
//      `chunk` rows; the block for (chunk s, 64 x 64 tile of gW) sums
//      x^T @ gz over its chunk in row order into a float32 partial, and the
//      blocks of the first tile row also sum gz's columns for gb;
//   3. reduce: one thread per element of gW and gb adds the `splits`
//      partials in chunk order.
// No atomics anywhere, so the result repeats bit for bit. Tiles and edge
// handling as in cross_layer.cu (cross_tile.cuh): zeros past B and d, no
// padded copies. At layer 0 x and x0 are one tensor; both are only read.
#include <cstdint>
#include <cuda_runtime.h>

#include "cross_tile.cuh"

namespace {

using namespace cross;

// Two blocks an SM (at most 128 registers a thread), so one block's loads
// overlap the other's FMAs.
__global__ void __launch_bounds__(kThreads, 2)
cross_bwd_dx_kernel(const float* x0, const float* x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ g,
                    float* __restrict__ gx0, float* __restrict__ gx, int64_t bsz, int d) {
  __shared__ __align__(16) Tile xs;    // xs[k][r]  = x[row0 + r][k0 + k]
  __shared__ __align__(16) Tile gzs;   // gzs[k][r] = gz[row0 + r][k0 + k]
  __shared__ __align__(16) Tile ws;    // ws[k][c]  = W[k0 + k][col0 + c]
  __shared__ __align__(16) Tile wts;   // wts[k][c] = W[col0 + c][k0 + k]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tr = threadIdx.x / (kBN / kTN), tc = threadIdx.x % (kBN / kTN);
  float z[kTM][kTN] = {};
  float t[kTM][kTN] = {};
  Frag fx, fgz, fw, fwt;
  fetch_t(fx, x, nullptr, bsz, d, row0, 0);
  fetch_t(fgz, g, x0, bsz, d, row0, 0);
  fetch_n(fw, w, nullptr, d, d, 0, col0);
  fetch_t(fwt, w, nullptr, d, d, col0, 0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    store_t(xs, fx);
    store_t(gzs, fgz);
    store_n(ws, fw);
    store_t(wts, fwt);
    __syncthreads();
    if (k0 + kBK < d) {  // the next slab's loads fly while this one is used
      fetch_t(fx, x, nullptr, bsz, d, row0, k0 + kBK);
      fetch_t(fgz, g, x0, bsz, d, row0, k0 + kBK);
      fetch_n(fw, w, nullptr, d, d, k0 + kBK, col0);
      fetch_t(fwt, w, nullptr, d, d, col0, k0 + kBK);
    }
    mma(xs, ws, z, tr, tc);
    mma(gzs, wts, t, tr, tc);
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
        const float ge = g[e];
        gx0[e] = __fmul_rn(ge, __fadd_rn(z[i][j], b[c]));
        gx[e] = __fadd_rn(t[i][j], ge);
      }
    }
  }
}

// part[s][m * d + n] = sum_{i in chunk s} x[i][m] * gz[i][n]; the blocks of
// tile row 0 also write part[s][d * d + n] = sum_{i in chunk s} gz[i][n].
__global__ void __launch_bounds__(kThreads)
cross_bwd_dw_kernel(const float* x0, const float* x, const float* __restrict__ g,
                    float* __restrict__ part, int64_t bsz, int d, int64_t chunk) {
  __shared__ __align__(16) Tile xs;    // xs[k][m]  = x[i0 + k][m0 + m]
  __shared__ __align__(16) Tile gzs;   // gzs[k][n] = gz[i0 + k][n0 + n]
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int64_t lo = static_cast<int64_t>(blockIdx.z) * chunk;
  const int64_t hi = lo + chunk < bsz ? lo + chunk : bsz;
  const int tr = threadIdx.x / (kBN / kTN), tc = threadIdx.x % (kBN / kTN);
  const bool colsum = blockIdx.y == 0 && threadIdx.x < kBN;
  float acc[kTM][kTN] = {};
  float bsum = 0.0f;
  Frag fx, fgz;
  fetch_n(fx, x, nullptr, hi, d, lo, m0);
  fetch_n(fgz, g, x0, hi, d, lo, n0);
  for (int64_t i0 = lo; i0 < hi; i0 += kBK) {
    store_n(xs, fx);
    store_n(gzs, fgz);
    __syncthreads();
    if (i0 + kBK < hi) {
      fetch_n(fx, x, nullptr, hi, d, i0 + kBK, m0);
      fetch_n(fgz, g, x0, hi, d, i0 + kBK, n0);
    }
    mma(xs, gzs, acc, tr, tc);
    if (colsum) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) bsum += gzs[k][threadIdx.x];
    }
    __syncthreads();
  }
  float* ps = part + static_cast<int64_t>(blockIdx.z) * (static_cast<int64_t>(d) * d + d);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + tr * kTM + i;
    if (m >= d) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tc * kTN + j;
      if (n < d) ps[static_cast<int64_t>(m) * d + n] = acc[i][j];
    }
  }
  if (colsum && n0 + static_cast<int>(threadIdx.x) < d)
    ps[static_cast<int64_t>(d) * d + n0 + threadIdx.x] = bsum;
}

// gw[e] = sum_s part[s][e] for e < d*d, gb[e - d*d] likewise after, in s order.
__global__ void cross_bwd_reduce_kernel(const float* __restrict__ part,
                                        float* __restrict__ gw, float* __restrict__ gb,
                                        int d, int splits) {
  const int64_t n = static_cast<int64_t>(d) * d + d;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = part[e];
  for (int k = 1; k < splits; ++k) s += part[k * n + e];
  if (e < static_cast<int64_t>(d) * d) {
    gw[e] = s;
  } else {
    gb[e - static_cast<int64_t>(d) * d] = s;
  }
}

}  // namespace

// `part` is float32 scratch of splits * (d*d + d) elements; chunk * splits
// must cover B with every chunk non-empty (the wrapper picks them). Writes
// gx0, gx [B, d], gw [d, d] and gb [d] on `stream`. Returns
// cudaGetLastError() of the three launches so the caller can raise.
extern "C" int cross_layer_bwd_launch(const void* x0, const void* x, const void* w,
                                      const void* b, const void* g, void* gx0, void* gx,
                                      void* gw, void* gb, void* part, int64_t bsz, int d,
                                      int64_t chunk, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int tiles_d = static_cast<unsigned int>((d + kBN - 1) / kBN);
  const float* fx0 = static_cast<const float*>(x0);
  const float* fx = static_cast<const float*>(x);
  const float* fg = static_cast<const float*>(g);
  float* fpart = static_cast<float*>(part);
  cross_bwd_dx_kernel<<<dim3(static_cast<unsigned int>((bsz + kBM - 1) / kBM), tiles_d),
                        kThreads, 0, st>>>(
      fx0, fx, static_cast<const float*>(w), static_cast<const float*>(b), fg,
      static_cast<float*>(gx0), static_cast<float*>(gx), bsz, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_bwd_dw_kernel<<<dim3(tiles_d, tiles_d, static_cast<unsigned int>(splits)),
                        kThreads, 0, st>>>(fx0, fx, fg, fpart, bsz, d, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(d) * d + d;
  cross_bwd_reduce_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, st>>>(
      fpart, static_cast<float*>(gw), static_cast<float*>(gb), d, splits);
  return static_cast<int>(cudaGetLastError());
}
