// Routed-gradient top-k decompression: out [m, D] (float32) is zero but for
// out[r, idx[r, j]] = vals[r, j]; columns outside [0, D) are dropped.
//
// Replaces topk_decompress_pallas (src/repro/kernels/grad_compress.py:143).
//
// Bound: bytes (8 bytes in a kept entry, 4 out an element). The TPU kernel
// builds a [256, D] block by k selects against a column iota. Here one
// thread owns one output element: it reads its row's k columns (L1 serves
// the row's other threads), takes the value whose column matches and
// writes once, so every element, zeros included, is one coalesced store.
// A value is set, not added, as the plain version's scatter sets it: a
// kept -0.0 stays -0.0. A row's columns are distinct, as compress gives
// them; were one repeated, the later entry would win.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void topk_decompress_kernel(const float* __restrict__ vals,
                                       const int32_t* __restrict__ idx,
                                       float* __restrict__ out, int64_t n, int d,
                                       int k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = i / d;
  const int c = static_cast<int>(i - r * d);
  float v = 0.0f;
  for (int j = 0; j < k; ++j) {
    if (idx[r * k + j] == c) v = vals[r * k + j];
  }
  out[i] = v;
}

}  // namespace

// n = m * D elements; launches on `stream` and returns cudaGetLastError().
extern "C" int topk_decompress_launch(const void* vals, const void* idx, void* out,
                                      int64_t n, int d, int k, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  topk_decompress_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n, d, k);
  return static_cast<int>(cudaGetLastError());
}
