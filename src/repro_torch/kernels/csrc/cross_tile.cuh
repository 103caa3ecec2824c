// Building blocks of the cross layer kernels (cross_layer.cu,
// cross_layer_bwd.cu): float32-accurate GEMM tiles on Hopper's tensor cores,
// fed by a cp.async ring and summed across a thread-block cluster.
//
// Tile. A block of kThreads = 256 threads (8 warps) computes a kBM x kBN =
// 64 x 64 output tile over its part of the contraction; warp w owns rows
// 32*(w/4).. and columns 16*(w%4).., two by two 16 x 8 tiles of
// mma.sync.m16n8k8 (tf32 in, float32 accumulators in registers).
//
// 3xTF32. Each operand element a is split into big = a rounded to nearest,
// ties away, to tf32 (cvt.rna.tf32.f32's rounding: truncation would lose a
// bit) and small = a - big, which the tensor core reads truncated to tf32.
// A slab accumulates small_a*big_b, then big_a*small_b, then big_a*big_b on
// the tensor cores in float32. The dropped small_a*small_b is below 2^-22
// of the product and small's truncation below 2^-21 of it, so the result
// keeps float32 accuracy (tests/test_torch_dcn.py emulates this split on
// the CPU; one tf32 product alone misses the 1e-5 bar at d = 429). The
// tensor cores do not round their sums to nearest, which biases a long
// chain, so each slab sums into fresh accumulators that are then added to
// the running total with float32 adds (slab_mma). Warp-level mma.sync, not
// wgmma: wgmma takes tf32 operands from shared memory in K-major layout
// only, and x @ W's B operand (W[k][n]) and dW's A operand (x^T, stored
// [batch][m]) are not K-major; mma.sync fragments come from registers,
// which scalar shared loads fill from either layout.
//
// Staging. Slabs of kBK = 32 along the contraction go through a ring of
// kStages buffers in shared memory with cp.async, kStages - 1 slabs in
// flight while the block computes on one; no registers hold the data on
// its way. The copies are 4 bytes each: a row of d = 429 floats is 1,716
// bytes, so most rows start off a 16-byte boundary, where a 16-byte
// cp.async is illegal and TMA (global strides in multiples of 16 bytes)
// cannot describe the tensor. A warp copies 32 neighbouring floats of a
// row. Elements past B, past d or past the block's part of the contraction
// are zero-filled (src-size 0), never skipped: every element of a stage is
// written for every slab, so no stale value survives, and no operand needs
// a padded copy in device memory. Two layouts:
//   rows:  s[r][k], 64 x 32, row stride kLdR = 36;
//   kmaj:  s[k][c], 32 x 64, row stride kLdK = 72;
// both strides put a warp's fragment loads on 32 distinct banks.
//
// Cluster. The C blocks of a cluster (C = 1, 2, 4 or 8, a template
// parameter) share an output tile and split its contraction in whole
// slabs, rank r taking slabs [S*r/C, S*(r+1)/C) of the S = ceil(n/32)
// (range_lo). Each rank leaves its float32 partial tile in its own shared
// memory; after cluster.sync() rank r reads rows [64r/C, 64(r+1)/C) of
// every rank's partial through distributed shared memory, adds them in rank
// order and finishes those rows, so the epilogue is spread over the
// cluster; a second cluster.sync() keeps every block's shared memory alive
// until all reads are done. No atomics anywhere: every sum has an order
// fixed by (B, d), through ops.cross_plan's cluster sizes, so results
// repeat bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cross {

namespace cg = cooperative_groups;

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 256;
constexpr int kLdR = kBK + 4;         // rows layout stride
constexpr int kLdK = kBN + 8;         // kmaj layout stride
constexpr int kLdC = kBN + 4;         // partial tile stride
constexpr int kRows = kBM * kLdR;     // floats of a rows slab
constexpr int kKmaj = kBK * kLdK;     // floats of a kmaj slab
constexpr int kPartial = kBM * kLdC;  // floats of a partial tile
static_assert(kThreads == 256 && kBM == 64 && kBN == 64 && kBK == 32, "copy split");

// First element of rank r's part of a contraction of n, in whole slabs
// (ops.cross_ranges computes the same).
template <int C>
__device__ __forceinline__ int64_t range_lo(int64_t n, int r) {
  const int64_t slabs = (n + kBK - 1) / kBK;
  const int64_t lo = slabs * r / C * kBK;
  return lo < n ? lo : n;
}

__device__ __forceinline__ void cp4(float* dst, const float* src, unsigned ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's copies of a rows slab: s[r][k] = a[(r0 + r) * ld + k0 + k]
// for r0 + r < rows and k0 + k < khi, else 0; r < 64, k < 32. Thread t
// copies column t%32 of rows t/32 + 8i, so a warp reads 32 neighbouring
// floats of a row. The row pointer and the rows' validity are worked out
// once; a slab then costs an add and a compare a copy. A zero-filled copy
// reads nothing, so its address may lie past the edge.
struct RowsCopy {
  const float* p;     // &a[(r0 + t/32) * ld + t%32]
  int ld8;            // 8 rows
  unsigned rows_ok;   // bit i: row r0 + t/32 + 8i < rows
  __device__ __forceinline__ RowsCopy(const float* a, int64_t rows, int ld, int64_t r0) {
    const int r = static_cast<int>(threadIdx.x) / kBK;
    p = a + (r0 + r) * ld + static_cast<int>(threadIdx.x) % kBK;
    ld8 = 8 * ld;
    rows_ok = 0;
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i) rows_ok |= (r0 + r + 8 * i < rows ? 1u : 0u) << i;
  }
  // shared-memory offset of this thread's i-th copy, i < kBM / 8
  __device__ __forceinline__ static int slot(int i) {
    const int t = static_cast<int>(threadIdx.x);
    return (t / kBK + 8 * i) * kLdR + t % kBK;
  }
  __device__ __forceinline__ void operator()(float* s, int k0, int khi) const {
    const int k = static_cast<int>(threadIdx.x) % kBK;
    float* d = s + slot(0);
    const unsigned ok = k0 + k < khi ? rows_ok : 0u;
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i) cp4(d + 8 * i * kLdR, p + k0 + i * ld8, ok >> i & 1u);
  }
};

// One thread's copies of a kmaj slab: s[k][c] = a[(k0 + k) * ld + c0 + c]
// for k0 + k < khi and c0 + c < cols, else 0; k < 32, c < 64. Thread t
// copies column t%64 of rows t/64 + 4i (a warp: 32 neighbouring floats).
struct KmajCopy {
  const float* p;  // &a[(t/64) * ld + c0 + t%64]
  int ld;
  bool c_ok;
  __device__ __forceinline__ KmajCopy(const float* a, int ld_, int cols, int c0) {
    const int c = static_cast<int>(threadIdx.x) % kBN;
    ld = ld_;
    p = a + static_cast<int64_t>(threadIdx.x / kBN) * ld + c0 + c;
    c_ok = c0 + c < cols;
  }
  // shared-memory offset of this thread's i-th copy, i < kBK / 4
  __device__ __forceinline__ static int slot(int i) {
    const int t = static_cast<int>(threadIdx.x);
    return (t / kBN + 4 * i) * kLdK + t % kBN;
  }
  __device__ __forceinline__ void operator()(float* s, int64_t k0, int64_t khi) const {
    const int k = static_cast<int>(threadIdx.x) / kBN;
    float* d = s + slot(0);
    const float* pk = p + k0 * ld;
    // rows of the slab this thread may copy, in 32 bits
    const int left = c_ok ? static_cast<int>(khi - k0 < kBK ? khi - k0 : kBK) - k : 0;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) cp4(d + 4 * i * kLdK, pk + 4 * i * ld, 4 * i < left);
  }
};

// The ring: load(s) issues slab s's copies into buffer s % S, compute(s)
// uses it. Every iteration commits one group (empty past the end), so
// wait_groups<S - 2> always means "slab s has landed". prep(s) runs between
// the wait and the barrier: a thread sees its own copies there, and may
// rewrite them before the block reads the slab. Ends with every copy done
// and the block synchronised, so the ring's memory can be reused.
struct NoPrep {
  __device__ __forceinline__ void operator()(int) const {}
};

template <int S, class Load, class Compute, class Prep = NoPrep>
__device__ __forceinline__ void ring(int n, Load load, Compute compute, Prep prep = Prep()) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load(s);
    commit();
  }
  for (int s = 0; s < n; ++s) {
    wait_groups<S - 2>();
    prep(s);
    __syncthreads();  // slab s is visible; buffer (s - 1) % S is free
    if (s + S - 1 < n) load(s + S - 1);
    commit();
    compute(s);
  }
  wait_groups<0>();
  __syncthreads();
}

// big: v rounded to nearest, ties away, to tf32 (what cvt.rna.tf32.f32
// gives for every input but NaN) in two integer operations: add half the
// unit of the 13 dropped bits, then clear them. small: v - big, exact in
// float32, handed to the tensor core whole: it reads the top 19 bits, so
// small is truncated to tf32 (an error below 2^-21 of v), and a NaN v stays
// NaN in small. Three instructions an element instead of two conversions.
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This thread's place in the tile: warp rows wm.., columns wn..; g = lane/4
// and t = lane%4 index the mma fragments.
struct Lane {
  int wm, wn, g, t;
  __device__ __forceinline__ Lane()
      : wm(threadIdx.x / 128 * 32), wn(threadIdx.x / 32 % 4 * 16), g(threadIdx.x % 32 / 4),
        t(threadIdx.x % 4) {}
};

typedef float Acc[2][2][4];

// total += A[.., 0:32] @ B[0:32, ..] over one slab in 3xTF32, A(m, k) and
// B(k, n) read from shared memory by the two accessors. The tensor cores
// add into their accumulators without rounding to nearest (the dropped bits
// bias a long sum), so a slab's product is summed in its own accumulators
// and then added to the running total with round-to-nearest float32 adds:
// no tensor-core sum runs longer than one slab, however long the
// contraction (a whole batch in dW).
template <class FA, class FB>
__device__ __forceinline__ void slab_mma(Acc& total, const Lane& l, FA fa, FB fb) {
  Acc acc = {};
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = l.wm + 16 * i + l.g, k = kk + l.t;
      split(fa(m, k), ab[i][0], as[i][0]);
      split(fa(m + 8, k), ab[i][1], as[i][1]);
      split(fa(m, k + 4), ab[i][2], as[i][2]);
      split(fa(m + 8, k + 4), ab[i][3], as[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = l.wn + 8 * j + l.g, k = kk + l.t;
      split(fb(k, n), bb[j][0], bs[j][0]);
      split(fb(k + 4, n), bb[j][1], bs[j][1]);
    }
    // term by term over the four tiles, so consecutive mma.syncs are
    // independent and the tensor core's latency overlaps
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) mma(acc[i][j], as[i], bb[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) mma(acc[i][j], ab[i], bs[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) mma(acc[i][j], ab[i], bb[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[i][j][e] = __fadd_rn(total[i][j][e], acc[i][j][e]);
}

// The accumulators to a [64][kLdC] partial tile in shared memory.
__device__ __forceinline__ void store_partial(float* p, const Acc& acc, const Lane& l) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = l.wm + 16 * i + l.g, c = l.wn + 8 * j + 2 * l.t;
      *reinterpret_cast<float2*>(p + r * kLdC + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + (r + 8) * kLdC + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// With a cluster of C, rank r finishes the tile's rows [64r/C, 64(r+1)/C):
// kShare(C) = 16/C elements a thread, the i-th in tile row share_row and
// column threadIdx.x % 64 (a warp covers 32 neighbouring columns of a row).
__host__ __device__ constexpr int kShare(int c) { return kBM * kBN / kThreads / c; }

template <int C>
__device__ __forceinline__ int share_row(int rank, int i) {
  return kBM / C * rank + (static_cast<int>(threadIdx.x) + i * kThreads) / kBN;
}

// After cluster.sync(): s[i][p] = the i-th element of this thread's share
// of partial tile p (NP tiles kPartial apart from `part`), summed over the C
// ranks in rank order through distributed shared memory. Every load is
// issued before the first add, so the C round trips overlap.
template <int C, int NP>
__device__ __forceinline__ void reduce_rows(cg::cluster_group cl, float* part,
                                            float (&s)[kShare(C)][NP]) {
  const int rank = static_cast<int>(cl.block_rank());
  const int col = static_cast<int>(threadIdx.x) % kBN;
  float v[C][kShare(C)][NP];
#pragma unroll
  for (int q = 0; q < C; ++q)
#pragma unroll
    for (int i = 0; i < kShare(C); ++i)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        v[q][i][p] = *cl.map_shared_rank(
            part + p * kPartial + share_row<C>(rank, i) * kLdC + col, q);
#pragma unroll
  for (int i = 0; i < kShare(C); ++i)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      s[i][p] = v[0][i][p];
#pragma unroll
      for (int q = 1; q < C; ++q) s[i][p] = __fadd_rn(s[i][p], v[q][i][p]);
    }
}

// Launch `kern` on a grid of clusters of `cluster` blocks along x, with
// `smem` bytes of dynamic shared memory, and return the launch's error: a
// cluster that cannot be scheduled is refused here and never runs. The
// caller then reads (and so clears) cudaGetLastError(), and reports the
// first error of the two.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kern)(Params...), dim3 grid, int cluster, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// kern<C>(args...) for the cluster sizes the kernels are built for (1, 2,
// 4, 8: ops.cross_plan's powers of two); any other size is refused.
#define CROSS_DISPATCH(kern, grid_of, cluster, smem, stream, ...)                      \
  ((cluster) == 1   ? launch_cluster(kern<1>, grid_of(1), 1, smem, stream, __VA_ARGS__) \
   : (cluster) == 2 ? launch_cluster(kern<2>, grid_of(2), 2, smem, stream, __VA_ARGS__) \
   : (cluster) == 4 ? launch_cluster(kern<4>, grid_of(4), 4, smem, stream, __VA_ARGS__) \
   : (cluster) == 8 ? launch_cluster(kern<8>, grid_of(8), 8, smem, stream, __VA_ARGS__) \
                    : cudaErrorInvalidValue)

}  // namespace cross
