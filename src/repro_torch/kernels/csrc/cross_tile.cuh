// Shared-memory tiles of a float32 GEMM, for the cross layer kernels
// (cross_layer.cu, cross_layer_bwd.cu).
//
// A block of kThreads threads computes a kBM x kBN output tile; each thread
// owns a kTM x kTN patch of it, rows tr*kTM.. and columns tc*kTN.. of the
// tile, so its operands come out of shared memory as one float4 of A and
// one of B per step of the contraction. The contraction runs over kBK-wide
// slabs staged in shared memory as s[kBK][kBM + kPad]: the padding keeps
// each row 16-byte aligned for the float4 reads and spreads the transposed
// stores over the banks. A slab is fetched from device memory into
// registers (Frag) while the block computes on the previous one, then
// stored to shared memory, so the loads' latency hides behind the FMAs.
// Rows and columns past the matrix edge load as 0, so no operand needs
// padding in device memory: d = 429 (rows of 1,716 bytes, not 16-byte
// aligned) is read with scalar loads, runs of 16 or 32 neighbouring floats
// per warp. Plain float32 FMAs, no tensor cores: the result keeps full
// float32 precision, like the plain version's cuBLAS call with TF32 off.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cross {

constexpr int kBM = 64, kBN = 64, kBK = 32, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPad = 4;
constexpr int kPer = kBM * kBK / kThreads;           // slab elements per thread
static_assert(kBM == kBN, "one tile shape serves both operands");
// fetch_t: 16 threads along a row, 16 rows a pass; fetch_n: kBN threads
// along a row, 4 rows a pass
static_assert(kThreads == 256 && kBN == 64 && kBM % 16 == 0 && kBK % 16 == 0 &&
                  kPer == (kBM / 16) * (kBK / 16) && kPer == kBK / 4,
              "slab split");

typedef float Tile[kBK][kBM + kPad];

// One thread's share of a slab, in registers between fetch and store.
struct Frag {
  float v[kPer];
};

// Transposed slab: element (r, c) = a[r0 + r][k0 + c] (times a2's element
// when a2 is given), r < kBM, c < kBK, of a row-major [rows, cols] matrix.
// Thread t holds rows t/16 + 16 i and columns t%16 + 16 j, so a warp reads
// two rows of 16 neighbouring floats; store_t puts (r, c) at s[c][r].
__device__ __forceinline__ void fetch_t(Frag& f, const float* a, const float* a2,
                                        int64_t rows, int cols, int64_t r0, int k0) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int64_t base = (r0 + tr) * cols + k0 + tc;
#pragma unroll
  for (int i = 0; i < kBM / 16; ++i) {
    const bool row_ok = r0 + tr + 16 * i < rows;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const int64_t o = base + static_cast<int64_t>(16 * i) * cols + 16 * j;
      float v = 0.0f;
      if (row_ok && k0 + tc + 16 * j < cols) v = a2 ? __fmul_rn(a[o], a2[o]) : a[o];
      f.v[j * (kBM / 16) + i] = v;
    }
  }
}

__device__ __forceinline__ void store_t(Tile& s, const Frag& f) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) s[tc + 16 * j][tr + 16 * i] = f.v[j * (kBM / 16) + i];
}

// Slab as it is: element (r, c) = a[k0 + r][c0 + c] (times a2's element when
// a2 is given), r < kBK, c < kBN, of a row-major [rows, cols] matrix. Thread
// t holds column t%64 of rows t/64 + 4 l, so a warp reads 32 neighbouring
// floats of one row; store_n puts (r, c) at s[r][c].
__device__ __forceinline__ void fetch_n(Frag& f, const float* a, const float* a2,
                                        int64_t rows, int cols, int64_t k0, int c0) {
  const int tr = threadIdx.x / kBN, tc = threadIdx.x % kBN;
  const bool col_ok = c0 + tc < cols;
  const int64_t base = (k0 + tr) * cols + c0 + tc;
#pragma unroll
  for (int l = 0; l < kPer; ++l) {
    const int64_t o = base + static_cast<int64_t>(4 * l) * cols;
    float v = 0.0f;
    if (col_ok && k0 + tr + 4 * l < rows) v = a2 ? __fmul_rn(a[o], a2[o]) : a[o];
    f.v[l] = v;
  }
}

__device__ __forceinline__ void store_n(Tile& s, const Frag& f) {
  const int tr = threadIdx.x / kBN, tc = threadIdx.x % kBN;
#pragma unroll
  for (int l = 0; l < kPer; ++l) s[tr + 4 * l][tc] = f.v[l];
}

// acc[i][j] += sum_k a[k][tr*kTM + i] * b[k][tc*kTN + j], k in slab order.
__device__ __forceinline__ void mma(const Tile& a, const Tile& b, float (&acc)[kTM][kTN],
                                    int tr, int tc) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][tr * kTM]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k][tc * kTN]);
    const float ar[kTM] = {av.x, av.y, av.z, av.w};
    const float br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

}  // namespace cross
