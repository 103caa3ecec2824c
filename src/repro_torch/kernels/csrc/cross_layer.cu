// DCN-v2 cross layer, forward:  out = x0 * (x @ W + b) + x,
// with x0, x [B, d], W [d, d], b [d], all float32 and row-major.
//
// Replaces cross_layer_pallas (src/repro/kernels/cross_layer.py:30).
//
// Bound. 2*B*d^2 multiply-adds against 3*B*d + d^2 floats moved, about 140
// operations a byte at d = 429. In 3xTF32 (3 * 2*B*d^2 tf32 operations at
// 495 TFLOP/s, 3.35 TB/s) the least time is 0.00114 ms at the serving
// path's B = 512 (operations), 0.00061 ms at the training path's B = 256
// (bytes) and 0.146 ms at bulk, B = 65,536 (operations). At the path shapes
// latency rules: one block per 64 x 64 tile would be 56 blocks at B = 512
// and 28 at B = 256 for 132 SMs, each walking all 14 slabs of d in turn.
//
// Design (cross_tile.cuh). A cluster of C blocks shares each 64 x 64
// output tile and splits d in whole 32-wide slabs: C = 2 at B = 512 and 4
// at B = 256 (112 blocks each), 1 at bulk, where the tiles alone fill the
// card (ops.cross_plan, fixed by (B, d)). Each rank stages its slabs
// through a 3-deep cp.async ring, multiplies them on the tensor cores in
// 3xTF32 and leaves its partial tile in shared memory; each rank then sums
// its rows of the tile over the cluster, in rank order, through distributed
// shared memory and applies the epilogue x0 * (acc + b) + x to them,
// rounding each step on its own (no FMA contraction) in the reference's
// order. The [B, d] product never goes to device memory, and no operand is
// padded there. Clusters run in row-major tile order, so the 7 column tiles
// of a row of x run side by side and x comes from device memory once. At
// layer 0 x and x0 are one tensor; both are only read.
//
// Resources (nvcc -Xptxas=-v, chip_smoke.py's [build] lines): 93 registers a
// thread at C = 2, 4 and 8, 128 with 8 bytes spilled at C = 1 (bulk);
// 55,296 bytes of dynamic shared memory (three stages of a 64 x 32 x slab
// and a 32 x 64 W slab; the partial tile reuses them), two blocks an SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "cross_tile.cuh"

namespace {

using namespace cross;

constexpr int kStages = 3;
constexpr int kStage = kRows + kKmaj;  // x slab, W slab
constexpr int kRing = kStages * kStage;
static_assert(kRing >= kPartial, "the partial tile reuses the ring");
constexpr size_t kSmem = sizeof(float) * kRing;

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
cross_layer_kernel(const float* x0, const float* x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out, int64_t bsz,
                   int d) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  // clusters in row-major tile order: the column tiles of a row of x run
  // side by side, so x's rows come from device memory once and then from L2
  const int tiles_d = (d + kBN - 1) / kBN;
  const int64_t tile = blockIdx.x / C;
  const int64_t row0 = tile / tiles_d * kBM;
  const int col0 = static_cast<int>(tile % tiles_d) * kBN;
  const int64_t klo = range_lo<C>(d, rank), khi = range_lo<C>(d, rank + 1);
  const RowsCopy cx(x, bsz, d, row0);  // [r][k] = x[row0 + r][k0 + k]
  const KmajCopy cw(w, d, d, col0);     // [k][n] = W[k0 + k][col0 + n]
  const Lane l;
  Acc acc = {};
  ring<kStages>(
      static_cast<int>((khi - klo + kBK - 1) / kBK),
      [&](int s) {
        float* st = smem + (s % kStages) * kStage;
        const int k0 = static_cast<int>(klo) + s * kBK;
        cx(st, k0, static_cast<int>(khi));
        cw(st + kRows, k0, khi);
      },
      [&](int s) {
        const float* xs = smem + (s % kStages) * kStage;
        const float* ws = xs + kRows;
        slab_mma(acc, l, [&](int m, int k) { return xs[m * kLdR + k]; },
                 [&](int k, int n) { return ws[k * kLdK + n]; });
      });
  store_partial(smem, acc, l);
  cl.sync();
  float z[kShare(C)][1];
  reduce_rows<C, 1>(cl, smem, z);
  // the epilogue's operands, all loaded before the first store
  const int cc = col0 + static_cast<int>(threadIdx.x) % kBN;
  const float bc = cc < d ? b[cc] : 0.0f;
  float a0[kShare(C)], a1[kShare(C)];
#pragma unroll
  for (int i = 0; i < kShare(C); ++i) {
    const int64_t row = row0 + share_row<C>(rank, i);
    const bool ok = row < bsz && cc < d;
    a0[i] = ok ? x0[row * d + cc] : 0.0f;
    a1[i] = ok ? x[row * d + cc] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kShare(C); ++i) {
    const int64_t row = row0 + share_row<C>(rank, i);
    if (row < bsz && cc < d)
      out[row * d + cc] = __fadd_rn(__fmul_rn(a0[i], __fadd_rn(z[i][0], bc)), a1[i]);
  }
  cl.sync();  // no block leaves while another still reads its partial
}

}  // namespace

// Launches on `stream` in clusters of `cluster` blocks (1, 2, 4 or 8, from
// ops.cross_plan); returns the launch's error code so the caller can raise.
extern "C" int cross_layer_launch(const void* x0, const void* x, const void* w,
                                  const void* b, void* out, int64_t bsz, int d, int cluster,
                                  void* stream) {
  const auto grid = [&](int c) {
    return dim3(static_cast<unsigned int>((bsz + kBM - 1) / kBM * ((d + kBN - 1) / kBN) * c));
  };
  const cudaError_t err = CROSS_DISPATCH(
      cross_layer_kernel, grid, cluster, kSmem, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x0), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(out),
      bsz, d);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
