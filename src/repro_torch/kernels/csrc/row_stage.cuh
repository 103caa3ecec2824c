// Staging of a block's tile of consecutive [m, D] float32 rows into shared
// memory, shared by the routed-gradient compression kernels
// (fp16_compress.cu, topk_compress.cu).
//
// A block owns `rows` consecutive rows, a multiple of 8 (ops.fp16_compress_plan,
// ops.topk_compress_plan), so one tile starts 32*D bytes after the one
// before it: every tile of g has g's own alignment mod 16, and every
// output tile starts on a 16-byte boundary of a fresh output (halves at
// 16*D bytes a tile, [rows, k] words at 32*k, a word a row at 32). The
// tile's rows*D floats are one contiguous range, copied by fm_stage.cuh's
// cp.async scheme in one round trip: 16-byte copies over its aligned
// middle, 4-byte ones for a head where g is a view 4, 8 or 12 bytes off 16
// and for the tail of a short last tile.
//
// A thread that scans one staged row starts at a column that depends on
// the row (row_scan_start): rows whose first floats fall in one shared-
// memory bank start at distinct columns, so a warp's 32 loads of a step
// fall in 32 banks whatever D is (one thread a row from column 0 would be
// a 16-way conflict at D = 16 and a 32-way one at D = 32). Neither
// kernel's result depends on the order of its scan.
#pragma once
#include <cstdint>

#include "fm_stage.cuh"

namespace {

// shared memory a block gets unasked; a staged tile and its other buffers
// fit in it (the plans check, and so do the launchers)
constexpr int kRowSmemBytes = 48 * 1024;

// Issues the copies of rows [r0, r0 + cnt) of g [*, d] into `buf` (16-byte
// aligned, cnt*d + 3 floats) by the block's threads; returns where row r0
// lands. The caller waits with fm_stage_wait() and a block barrier.
__device__ __forceinline__ const float* row_stage_issue(float* buf, const float* g, int64_t r0,
                                                        int cnt, int d) {
  return fm_stage_issue(buf, g + r0 * d, cnt * d);
}

// The column at which the thread on row r (of a tile) starts its scan.
// Rows r and r' of one warp start in the same bank exactly when r = r' mod
// 32/p, p = gcd(D, 32): those p rows start at columns 0 .. p-1, so a step
// of the scan puts them in distinct banks mod p and the others apart.
__device__ __forceinline__ int row_scan_start(int d, int r) {
  const int p = (d & -d) < 32 ? (d & -d) : 32;
  return ((r & 31) * p) >> 5;
}

// Writes n consecutive 4-byte words from shared `src` (16-byte aligned) to
// `dst` (16-byte aligned) with the block's threads: 16-byte stores, then
// the last n % 4 words (only a short last tile has them) one by one.
template <typename T>
__device__ __forceinline__ void row_store_words(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4, "4-byte words");
  for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  if (static_cast<int>(threadIdx.x) < (n & 3)) {
    dst[(n & ~3) + threadIdx.x] = src[(n & ~3) + threadIdx.x];
  }
}

}  // namespace
