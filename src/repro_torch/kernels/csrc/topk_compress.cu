// Routed-gradient top-k compression of g [m, D] (float32): per row, the k
// entries of largest magnitude, in descending order, ties to the lower
// column, as vals [m, k] (float32, signed) and idx [m, k] (int32).
//
// Replaces topk_compress_pallas (src/repro/kernels/grad_compress.py:108).
//
// Bound: bytes (4 bytes in an element, 8 out a kept entry; k * D compares a
// row at most). The TPU kernel runs k first-argmax passes over a [256, D]
// block, masking what it has taken. Here one thread selects a row. The
// selection is defined by an order (magnitude descending, a NaN above
// every number, ties and NaNs by ascending column), so any scan finds the
// same columns, and vals = row[idx] keeps each value's bits. The order is
// one unsigned comparison of 64-bit keys (|x|'s bits, every NaN made one
// value, above the column's complement), where the earlier kernel spent a
// dozen float tests. For k <= 8 one scan inserts each key into a sorted
// list of K = 1, 2, 4 or 8 (k rounded up, a template) kept in registers;
// past 8, k passes each take the largest key below the previous pass's
// pick, as the earlier kernel's passes did, so no state grows with D.
//
// Two routes, chosen by ops.topk_compress_plan:
//  - k <= 8 (every training path: k = D / 4 at D = 4, 10, 16, 32), direct:
//    a block of `rows` threads, a thread a row, reads its row from g
//    (a warp's rows are one contiguous range: its first loads bring the
//    lines to L1, the rest hit there) and writes its k pairs. On the H100
//    this ran faster than staging at every width and tile the sweep of
//    scripts/torch_compress_bench.py times (D = 1-32, bulk included): one
//    scan does not pay for a tile's copy, its wait and its barrier;
//  - k > 8, staged: the passes read a row k times, so a block copies a tile
//    of `rows` consecutive rows (a multiple of 8, a block an SM where m
//    allows) into shared memory with coalesced 16-byte cp.async copies
//    (row_stage.cuh), each thread scans its staged row from a start
//    rotated by row (no bank conflicts), writes its pairs to the tile's
//    [rows, k] vals and idx in shared memory, and after a barrier the block
//    writes both whole with 16-byte stores (a tile's base, r0 * k * 4
//    bytes, is a multiple of 32; only the last tile can end in a scalar
//    tail). At D = 129, k = 32 this halved the direct route's time. Past
//    the 48 KB of shared memory a block gets unasked (eight rows of 6 * D
//    floats at k = D / 4: D > 1,023) it goes direct too.
#include <cstdint>
#include <cuda_runtime.h>

#include "row_stage.cuh"

namespace {

// An entry's rank as one 64-bit key, the larger first: |x|'s bits above
// (a non-negative float orders like its bits as an unsigned integer; every
// NaN is made one value above +inf, so NaNs tie), the column's complement
// below (ties to the lower column). Every key is above 0.
__device__ __forceinline__ uint64_t rank_key(float x, int c) {
  const float a = fabsf(x);
  const uint32_t hi = (a != a) ? 0x7fc00000u : __float_as_uint(a);
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(~c);
}

__device__ __forceinline__ int key_col(uint64_t key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

// k <= K: one scan, columns c0 .. D-1 then 0 .. c0-1, inserts each entry's
// key into a list of K kept sorted in registers (slots start at key 0,
// below every entry); the first k go to ov and oi.
template <int K>
__device__ __forceinline__ void topk_insert(const float* row, int d, int k, int c0, float* ov,
                                            int32_t* oi) {
  uint64_t key[K];
#pragma unroll
  for (int j = 0; j < K; ++j) key[j] = 0;
  auto take = [&](int c) {
    const uint64_t x = rank_key(row[c], c);
    bool b[K];  // x ranks before slot j (true from some j on)
#pragma unroll
    for (int j = 0; j < K; ++j) b[j] = x > key[j];
#pragma unroll
    for (int j = K - 1; j > 0; --j) key[j] = b[j - 1] ? key[j - 1] : (b[j] ? x : key[j]);
    if (b[0]) key[0] = x;
  };
#pragma unroll 4
  for (int c = c0; c < d; ++c) take(c);
#pragma unroll 4
  for (int c = 0; c < c0; ++c) take(c);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      const int c = key_col(key[j]);
      ov[j] = row[c];
      oi[j] = c;
    }
  }
}

// k passes, each scanning (from column c0) for the largest key below the
// previous pass's pick.
__device__ __forceinline__ void topk_passes(const float* row, int d, int k, int c0, float* ov,
                                            int32_t* oi) {
  uint64_t prev = ~0ull;
  for (int p = 0; p < k; ++p) {
    uint64_t best = 0;
    auto take = [&](int c) {
      const uint64_t x = rank_key(row[c], c);
      if (x < prev && x > best) best = x;
    };
#pragma unroll 4
    for (int c = c0; c < d; ++c) take(c);
#pragma unroll 4
    for (int c = 0; c < c0; ++c) take(c);
    const int c = key_col(best);
    ov[p] = row[c];
    oi[p] = c;
    prev = best;
  }
}

template <int K>
__device__ __forceinline__ void topk_row(const float* row, int d, int k, int c, float* ov,
                                         int32_t* oi) {
  if constexpr (K > 0) {
    topk_insert<K>(row, d, k, c, ov, oi);
  } else {
    topk_passes(row, d, k, c, ov, oi);
  }
}

template <int K>
__global__ void topk_compress_kernel_staged(const float* __restrict__ g,
                                            float* __restrict__ vals,
                                            int32_t* __restrict__ idx, int64_t m, int d, int k,
                                            int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int cnt = static_cast<int>(m - r0 < rows ? m - r0 : rows);
  // shared: the tile's vals and idx ([rows, k] each: 8 * rows * k bytes, so
  // the staging buffer after them stays 16-byte aligned), then the rows
  float* sv = smem;
  int32_t* si = reinterpret_cast<int32_t*>(smem + rows * k);
  const float* x = row_stage_issue(smem + 2 * rows * k, g, r0, cnt, d);
  fm_stage_wait();
  __syncthreads();
  for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
    topk_row<K>(x + r * d, d, k, row_scan_start(d, r), sv + r * k, si + r * k);
  }
  __syncthreads();
  row_store_words(vals + r0 * k, sv, cnt * k);
  row_store_words(idx + r0 * k, si, cnt * k);
}

template <int K>
__global__ void topk_compress_kernel_direct(const float* __restrict__ g,
                                            float* __restrict__ vals,
                                            int32_t* __restrict__ idx, int64_t m, int d, int k,
                                            int rows) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int cnt = static_cast<int>(m - r0 < rows ? m - r0 : rows);
  for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
    const int64_t at = r0 + r;
    topk_row<K>(g + at * d, d, k, 0, vals + at * k, idx + at * k);
  }
}

template <int K>
void launch(bool staged, unsigned int blocks, int threads, size_t smem, cudaStream_t st,
            const float* g, float* vals, int32_t* idx, int64_t m, int d, int k, int rows) {
  if (staged) {
    topk_compress_kernel_staged<K><<<blocks, threads, smem, st>>>(g, vals, idx, m, d, k, rows);
  } else {
    topk_compress_kernel_direct<K><<<blocks, threads, 0, st>>>(g, vals, idx, m, d, k, rows);
  }
}

}  // namespace

// Needs 0 < k <= d (the wrapper checks). Launches on `stream` with
// ops.topk_compress_plan's (rows, threads, staged); a staged block takes
// (rows * (D + 2k) + 3) floats of shared memory, at most 48 KB, and vals
// and idx must be 16-byte aligned. Returns cudaGetLastError().
extern "C" int topk_compress_launch(const void* g, void* vals, void* idx, int64_t m, int d,
                                    int k, int rows, int threads, int staged, void* stream) {
  if (m <= 0 || d <= 0 || k <= 0 || k > d || rows <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || static_cast<int64_t>(rows) * (d + 2 * k) > (1 << 28) ||
      (staged && (rows % 8 != 0 || ((reinterpret_cast<uintptr_t>(vals) |
                                     reinterpret_cast<uintptr_t>(idx)) & 15u) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (m + rows - 1) / rows;
  const size_t smem = (static_cast<size_t>(rows) * (d + 2 * k) + 3) * sizeof(float);
  if (blocks > 0x7fffffff || (staged && smem > static_cast<size_t>(kRowSmemBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int nb = static_cast<unsigned int>(blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  float* vp = static_cast<float*>(vals);
  int32_t* ip = static_cast<int32_t*>(idx);
  const bool on = staged != 0;
  if (k == 1) {
    launch<1>(on, nb, threads, smem, st, gp, vp, ip, m, d, k, rows);
  } else if (k == 2) {
    launch<2>(on, nb, threads, smem, st, gp, vp, ip, m, d, k, rows);
  } else if (k <= 4) {
    launch<4>(on, nb, threads, smem, st, gp, vp, ip, m, d, k, rows);
  } else if (k <= 8) {
    launch<8>(on, nb, threads, smem, st, gp, vp, ip, m, d, k, rows);
  } else {
    launch<0>(on, nb, threads, smem, st, gp, vp, ip, m, d, k, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
