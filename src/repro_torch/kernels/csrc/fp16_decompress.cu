// Routed-gradient fp16 decompression: out[r, c] = float(q[r, c]) * s[r] for
// q [m, D] (half) and s [m, 1] (float32).
//
// Replaces fp16_decompress_pallas (src/repro/kernels/grad_compress.py:65).
//
// Bound: bytes (2 bytes in and 4 out for one multiply an element). The TPU
// kernel scales a [256, D] block in VMEM. Here one thread owns one element,
// so neighbouring threads read neighbouring halves and write neighbouring
// floats; the row's scale comes from L1. The half-to-float conversion is
// exact and the product is one rounded multiply, as in the plain version.
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fp16_decompress_kernel(const __half* __restrict__ q,
                                       const float* __restrict__ s,
                                       float* __restrict__ out, int64_t n, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = __half2float(q[i]) * s[i / d];
}

}  // namespace

// n = m * D elements; launches on `stream` and returns cudaGetLastError().
extern "C" int fp16_decompress_launch(const void* q, const void* s, void* out,
                                      int64_t n, int d, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fp16_decompress_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}
