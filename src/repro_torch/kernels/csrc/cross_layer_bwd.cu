// DCN-v2 cross layer, backward: from x0, x [B, d], W [d, d], b [d] and the
// cotangent g [B, d] of out = x0 * (x @ W + b) + x,
//   gz  = g * x0                 (never stored)
//   gx0 = g * (x @ W + b)        (z recomputed)
//   gx  = gz @ W^T + g
//   gW  = x^T @ gz,  gb = sum_B gz.
//
// Replaces cross_layer_bwd_pallas (src/repro/kernels/interaction_bwd.py:147).
//
// Bound. Three GEMMs, 6*B*d^2 operations against 5*B*d + 2*d^2 floats
// moved. In 3xTF32 (3 * 6*B*d^2 tf32 operations at 495 TFLOP/s) the least
// time is 0.00171 ms at the training path's B = 256 and 0.438 ms at bulk
// (B = 65,536), both operations. At the path shape latency rules: 28 output
// tiles of [B, d] and 49 of [d, d] for 132 SMs.
//
// Hopper runs blocks in no order, so the TPU kernel's sequential grid,
// which carries gW and gb across batch tiles in its output blocks, becomes
// two kernels on one stream, both built from cross_tile.cuh (3xTF32
// mma.sync, a 3-deep cp.async ring, clusters summing in rank order through
// distributed shared memory):
//   1. dx: one GEMM a cluster. The tiles of gx0 (x @ W, then g * (z + b))
//      and of gx (gz @ W^T, then + g) form one grid, twice the [B, d]
//      tiles, in row-major tile order so the rows of x, g and x0 come from
//      device memory once; a cluster of C_dx blocks (2 at B = 256) splits d
//      in whole slabs. gz = g * x0 is formed in shared memory, each thread
//      multiplying its own copies of a slab between the cp.async wait and
//      the block's barrier; W^T's slab is copied from W's rows, so no
//      transpose is made.
//   2. dw: a cluster of C_dw blocks (4 at B = 256 and at bulk) per 64 x 64
//      tile of gW splits the batch in whole 32-row slabs; each rank sums
//      x^T @ gz over its rows (gz formed as in dx), the clusters of tile
//      row 0 also gz's columns for gb, and the ranks' partials are summed
//      in rank order into gW and gb. This replaces the earlier split-K
//      scratch of splits * (d^2 + d) floats (47 MB written and read again
//      at bulk) and the third kernel that reduced it.
// C_dx and C_dw are ops.cross_plan's, fixed by (B, d). No atomics: the
// result repeats bit for bit. Edges are zero-filled in shared memory, as in
// cross_layer.cu: no padded copies. At layer 0 x and x0 are one tensor;
// both are only read.
//
// Resources (nvcc -Xptxas=-v, chip_smoke.py's [build] lines): dx 92 registers a
// thread at C = 2, 4 and 8, 120 at C = 1; dw 95 at every C; no spills;
// 82,944 bytes of dynamic shared memory in each kernel (three stages of
// three slabs), two blocks an SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "cross_tile.cuh"

namespace {

using namespace cross;

constexpr int kStages = 3;
constexpr int kDxStage = 3 * kRows;  // x, W (kmaj); or g, x0, W^T (rows)
constexpr int kDwStage = 3 * kKmaj;  // x, g, x0 (kmaj)
constexpr size_t kDxSmem = sizeof(float) * kStages * kDxStage;
constexpr size_t kDwSmem = sizeof(float) * kStages * kDwStage;
static_assert(kRows + kKmaj <= kDxStage && kStages * kDxStage >= kPartial &&
                  kStages * kDwStage >= kPartial + kBN,
              "the stages hold their slabs; the partial tiles reuse the ring");

// One output tile of the dx pass. kKind 0: z = x @ W, written as
// gx0 = g * (z + b); kKind 1: t = gz @ W^T, written as gx = t + g.
template <int C, int kKind>
__device__ __forceinline__ void dx_tile(float* smem, const float* x0, const float* x,
                                        const float* w, const float* b, const float* g,
                                        float* out, int64_t bsz, int d, int64_t row0,
                                        int col0) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int64_t klo = range_lo<C>(d, rank), khi = range_lo<C>(d, rank + 1);
  // kKind 0: [r][k] = x[row0 + r][k0 + k] and [k][n] = W[k0 + k][col0 + n];
  // kKind 1: [r][k] = g[row0 + r][k0 + k], x0 likewise, [n][k] = W[col0 + n][k0 + k]
  const RowsCopy ca(kKind == 0 ? x : g, bsz, d, row0);
  const RowsCopy cx0(x0, bsz, d, row0);
  const RowsCopy cwt(w, d, d, col0);
  const KmajCopy cw(w, d, d, col0);
  const Lane l;
  Acc acc = {};
  ring<kStages>(
      static_cast<int>((khi - klo + kBK - 1) / kBK),
      [&](int s) {
        float* st = smem + (s % kStages) * kDxStage;
        const int k0 = static_cast<int>(klo) + s * kBK, kh = static_cast<int>(khi);
        ca(st, k0, kh);
        if constexpr (kKind == 0) {
          cw(st + kRows, k0, khi);
        } else {
          cx0(st + kRows, k0, kh);
          cwt(st + 2 * kRows, k0, kh);
        }
      },
      [&](int s) {
        const float* st = smem + (s % kStages) * kDxStage;
        if constexpr (kKind == 0) {
          slab_mma(acc, l, [&](int m, int k) { return st[m * kLdR + k]; },
                   [&](int k, int n) { return st[kRows + k * kLdK + n]; });
        } else {  // gz, then W^T
          slab_mma(acc, l, [&](int m, int k) { return st[m * kLdR + k]; },
                   [&](int k, int n) { return st[2 * kRows + n * kLdR + k]; });
        }
      },
      [&](int s) {  // kKind 1: gz = g * x0 in place of this thread's g copies
        if constexpr (kKind == 1) {
          float* st = smem + (s % kStages) * kDxStage;
#pragma unroll
          for (int i = 0; i < kBM / 8; ++i) {
            const int e = RowsCopy::slot(i);
            st[e] = __fmul_rn(st[e], st[kRows + e]);
          }
        }
      });
  store_partial(smem, acc, l);
  cl.sync();
  float s[kShare(C)][1];
  reduce_rows<C, 1>(cl, smem, s);
  // the epilogue's operands, all loaded before the first store
  const int cc = col0 + static_cast<int>(threadIdx.x) % kBN;
  const float bc = kKind == 0 && cc < d ? b[cc] : 0.0f;
  float ge[kShare(C)];
#pragma unroll
  for (int i = 0; i < kShare(C); ++i) {
    const int64_t row = row0 + share_row<C>(rank, i);
    ge[i] = row < bsz && cc < d ? g[row * d + cc] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kShare(C); ++i) {
    const int64_t row = row0 + share_row<C>(rank, i);
    if (row < bsz && cc < d)
      out[row * d + cc] = kKind == 0 ? __fmul_rn(ge[i], __fadd_rn(s[i][0], bc))
                                     : __fadd_rn(s[i][0], ge[i]);
  }
  cl.sync();  // no block leaves while another still reads its partial
}

// Clusters in row-major tile order over [B, 2d]: in each row of tiles the
// first T = ceil(d/64) compute gx0, the next T gx, side by side, so the
// rows of x, g and x0 come from device memory once and then from L2.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
cross_bwd_dx_kernel(const float* x0, const float* x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ g,
                    float* __restrict__ gx0, float* __restrict__ gx, int64_t bsz, int d) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_d = (d + kBN - 1) / kBN;
  const int64_t tile = blockIdx.x / C;
  const int64_t row0 = tile / (2 * tiles_d) * kBM;
  const int j = static_cast<int>(tile % (2 * tiles_d));
  if (j < tiles_d)
    dx_tile<C, 0>(smem, x0, x, w, b, g, gx0, bsz, d, row0, j * kBN);
  else
    dx_tile<C, 1>(smem, x0, x, w, b, g, gx, bsz, d, row0, (j - tiles_d) * kBN);
}

// gw[m][n] = sum_i x[i][m] * gz[i][n]; the clusters of tile row 0 also
// write gb[n] = sum_i gz[i][n].
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
cross_bwd_dw_kernel(const float* x0, const float* x, const float* __restrict__ g,
                    float* __restrict__ gw, float* __restrict__ gb, int64_t bsz, int d) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int n0 = static_cast<int>(blockIdx.x / C) * kBN, m0 = blockIdx.y * kBM;
  const int64_t ilo = range_lo<C>(bsz, rank), ihi = range_lo<C>(bsz, rank + 1);
  const bool colsum = blockIdx.y == 0;  // the same for every rank of the cluster
  const KmajCopy cx(x, d, d, m0);    // [k][m] = x[i0 + k][m0 + m]
  const KmajCopy cgrad(g, d, d, n0);   // [k][n] = g[i0 + k][n0 + n]
  const KmajCopy cx0(x0, d, d, n0);  // x0, likewise
  const Lane l;
  Acc acc = {};
  float bsum = 0.0f;
  ring<kStages>(
      static_cast<int>((ihi - ilo + kBK - 1) / kBK),
      [&](int s) {
        float* st = smem + (s % kStages) * kDwStage;
        const int64_t i0 = ilo + static_cast<int64_t>(s) * kBK;
        cx(st, i0, ihi);
        cgrad(st + kKmaj, i0, ihi);
        cx0(st + 2 * kKmaj, i0, ihi);
      },
      [&](int s) {
        const float* xs = smem + (s % kStages) * kDwStage;
        const float* gzs = xs + kKmaj;
        slab_mma(acc, l, [&](int m, int k) { return xs[k * kLdK + m]; },
                 [&](int k, int n) { return gzs[k * kLdK + n]; });
        if (colsum && threadIdx.x < kBN) {
#pragma unroll
          for (int k = 0; k < kBK; ++k) bsum = __fadd_rn(bsum, gzs[k * kLdK + threadIdx.x]);
        }
      },
      [&](int s) {  // gz = g * x0 in place of this thread's g copies
        float* st = smem + (s % kStages) * kDwStage;
#pragma unroll
        for (int i = 0; i < kBK / 4; ++i) {
          const int e = KmajCopy::slot(i);
          st[kKmaj + e] = __fmul_rn(st[kKmaj + e], st[2 * kKmaj + e]);
        }
      });
  store_partial(smem, acc, l);
  if (colsum && threadIdx.x < kBN) smem[kPartial + threadIdx.x] = bsum;
  cl.sync();
  float s[kShare(C)][1];
  reduce_rows<C, 1>(cl, smem, s);
  const int n = n0 + static_cast<int>(threadIdx.x) % kBN;
#pragma unroll
  for (int i = 0; i < kShare(C); ++i) {
    const int m = m0 + share_row<C>(rank, i);
    if (m < d && n < d) gw[static_cast<int64_t>(m) * d + n] = s[i][0];
  }
  if (colsum && rank == 0 && threadIdx.x < kBN && n < d) {
    float v[C];
#pragma unroll
    for (int q = 0; q < C; ++q) v[q] = *cl.map_shared_rank(smem + kPartial + threadIdx.x, q);
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < C; ++q) sum = __fadd_rn(sum, v[q]);
    gb[n] = sum;
  }
  cl.sync();  // no block leaves while another still reads its partial
}

}  // namespace

// Writes gx0, gx [B, d], gw [d, d] and gb [d] on `stream`: the dx kernel in
// clusters of `cluster_dx` blocks, the dw kernel in clusters of
// `cluster_dw` (each 1, 2, 4 or 8, from ops.cross_plan). Returns the first
// launch error so the caller can raise.
extern "C" int cross_layer_bwd_launch(const void* x0, const void* x, const void* w,
                                      const void* b, const void* g, void* gx0, void* gx,
                                      void* gw, void* gb, int64_t bsz, int d, int cluster_dx,
                                      int cluster_dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int tiles_d = static_cast<unsigned int>((d + kBN - 1) / kBN);
  const float* fx0 = static_cast<const float*>(x0);
  const float* fx = static_cast<const float*>(x);
  const float* fg = static_cast<const float*>(g);
  const auto dx_grid = [&](int c) {
    return dim3(static_cast<unsigned int>((bsz + kBM - 1) / kBM * 2 * tiles_d * c));
  };
  const auto dw_grid = [&](int c) { return dim3(tiles_d * c, tiles_d); };
  cudaError_t err = CROSS_DISPATCH(cross_bwd_dx_kernel, dx_grid, cluster_dx, kDxSmem, st, fx0,
                                   fx, static_cast<const float*>(w),
                                   static_cast<const float*>(b), fg, static_cast<float*>(gx0),
                                   static_cast<float*>(gx), bsz, d);
  cudaError_t last = cudaGetLastError();
  if (err != cudaSuccess || last != cudaSuccess)
    return static_cast<int>(err != cudaSuccess ? err : last);
  err = CROSS_DISPATCH(cross_bwd_dw_kernel, dw_grid, cluster_dw, kDwSmem, st, fx0, fx, fg,
                       static_cast<float*>(gw), static_cast<float*>(gb), bsz, d);
  last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
