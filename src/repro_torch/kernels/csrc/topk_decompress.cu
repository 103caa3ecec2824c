// Routed-gradient top-k decompression: out [m, D] (float32) is zero but for
// out[r, idx[r, j]] = vals[r, j]; columns outside [0, D) are dropped.
//
// Replaces topk_decompress_pallas (src/repro/kernels/grad_compress.py:143).
//
// Bound: bytes (8 bytes in a kept entry, 4 out an element). The TPU kernel
// builds a [256, D] block by k selects against a column iota. Here a block
// owns a tile of `rows` consecutive rows (ops.topk_decompress_plan: a
// multiple of 4, so every tile's rows*D floats start on a 16-byte boundary
// of out; at least one block an SM where m allows) and builds it in shared
// memory:
//  1. the block zeroes the tile;
//  2. the thread that owns row r reads its k (idx, vals) pairs in
//     ascending j (neighbouring threads on neighbouring rows) and sets
//     tile[r, c] = v for each column c in [0, D), tested as unsigned so
//     negative ones drop too. The value is set, not added, as the plain
//     version's scatter sets it: a kept -0.0 stays -0.0, a NaN is copied as
//     it is, and on a repeated column the later entry wins;
//  3. the block writes the tile whole with 16-byte coalesced stores; only
//     the last tile takes a scalar tail, where m*D is not a multiple of 4.
// Index arithmetic inside a tile is 32-bit with no division; only the
// tile's base is 64-bit. Where even four rows pass the 48 KB of shared
// memory a block gets unasked (D > 3,072), the same three steps run on
// out itself: the barrier after the zeroes orders them before the values.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSmemBytes = 48 * 1024;

template <bool kStaged>
__global__ void topk_decompress_kernel(const float* __restrict__ vals,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int64_t m, int d, int k,
                                       int rows) {
  extern __shared__ float4 smem4[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int cnt = static_cast<int>(m - r0 < rows ? m - r0 : rows);
  const int n = cnt * d;
  float* base = out + r0 * d;
  float* tile = kStaged ? reinterpret_cast<float*>(smem4) : base;
  // the shared tile is whole float4s; out takes only its n floats
  const int z4 = kStaged ? (n + 3) >> 2 : n >> 2;
  for (int i = threadIdx.x; i < z4; i += blockDim.x) {
    reinterpret_cast<float4*>(tile)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (!kStaged && static_cast<int>(threadIdx.x) < (n & 3)) tile[(n & ~3) + threadIdx.x] = 0.0f;
  __syncthreads();
  const unsigned ud = static_cast<unsigned>(d);
  for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
    const int32_t* ri = idx + (r0 + r) * k;
    const float* rv = vals + (r0 + r) * k;
    float* row = tile + r * d;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const unsigned c = static_cast<unsigned>(__ldg(ri + j));
      const float v = __ldg(rv + j);
      if (c < ud) row[c] = v;
    }
  }
  if (!kStaged) return;
  __syncthreads();
  for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x) {
    reinterpret_cast<float4*>(base)[i] = reinterpret_cast<const float4*>(tile)[i];
  }
  if (static_cast<int>(threadIdx.x) < (n & 3)) {
    base[(n & ~3) + threadIdx.x] = tile[(n & ~3) + threadIdx.x];
  }
}

}  // namespace

// Launches on `stream` with ops.topk_decompress_plan's (rows, threads);
// a tile takes rows*D floats of shared memory where that is at most 48 KB.
// Returns cudaGetLastError() so the caller can raise.
extern "C" int topk_decompress_launch(const void* vals, const void* idx, void* out, int64_t m,
                                      int d, int k, int rows, int threads, void* stream) {
  if (m <= 0 || d <= 0 || k < 0 || rows <= 0 || rows % 4 != 0 || threads <= 0 ||
      threads > 1024 || threads % 32 != 0 || static_cast<int64_t>(rows) * d > (1 << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (m + rows - 1) / rows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows) * d * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vp = static_cast<const float*>(vals);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  if (smem <= static_cast<size_t>(kSmemBytes)) {
    topk_decompress_kernel<true><<<static_cast<unsigned int>(blocks), threads, smem, st>>>(
        vp, ip, op, m, d, k, rows);
  } else {
    topk_decompress_kernel<false><<<static_cast<unsigned int>(blocks), threads, 0, st>>>(
        vp, ip, op, m, d, k, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
