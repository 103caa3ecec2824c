// Routed-gradient fp16 compression of g [m, D] (float32), per row r:
//   s[r] = max_c |g[r, c]|,  q[r, c] = half(g[r, c] / max(s[r], 1e-30)).
//
// Replaces fp16_compress_pallas (src/repro/kernels/grad_compress.py:39).
//
// Bound: bytes. Each element is read once (4 bytes) and written once as a
// half (2 bytes) for an abs, a max and a division. The TPU kernel computes
// a [256, D] block's scales and casts in one VMEM pass. Here one thread owns
// one row (D <= 16 on the training path): a first pass over its D floats
// finds the amax, a second reads them again, from L1, and writes the halves.
// The division is IEEE and __float2half_rn rounds to nearest even, with no
// flush to zero (the build has no --use_fast_math), so q matches the plain
// version bit for bit, f16 subnormals included. The max keeps NaN, as
// torch.amax and jnp.max do: a row holding a NaN gives s = NaN and q NaN.
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// max that keeps a NaN from either side (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void fp16_compress_kernel(const float* __restrict__ g,
                                     __half* __restrict__ q,
                                     float* __restrict__ s, int64_t m, int d) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= m) return;
  const float* row = g + r * d;
  float amax = 0.0f;
  for (int c = 0; c < d; ++c) amax = nan_max(fabsf(row[c]), amax);
  const float denom = nan_max(amax, 1e-30f);
  __half* out = q + r * d;
  for (int c = 0; c < d; ++c) out[c] = __float2half_rn(row[c] / denom);
  s[r] = amax;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int fp16_compress_launch(const void* g, void* q, void* s, int64_t m,
                                    int d, void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  fp16_compress_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<__half*>(q),
      static_cast<float*>(s), m, d);
  return static_cast<int>(cudaGetLastError());
}
