// Routed-gradient top-k compression of g [m, D] (float32): per row, the k
// entries of largest magnitude, in descending order, ties to the lower
// column, as vals [m, k] (float32, signed) and idx [m, k] (int32).
//
// Replaces topk_compress_pallas (src/repro/kernels/grad_compress.py:108).
//
// Bound: bytes (4 bytes in an element, 8 out a kept entry; k * D compares a
// row). The TPU kernel runs k first-argmax passes over a [256, D] block,
// masking what it has taken. Here one thread owns one row (D <= 16, k <= 4
// on the training path) and runs the same k passes over its D floats, which
// stay in L1 after the first. Instead of a mask, pass p takes the best
// entry that ranks after pass p-1's pick in the order (magnitude
// descending, column ascending), so no state grows with D. A NaN ranks
// above every number and NaNs by column, as in lax.top_k and the plain
// version's stable descending sort.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// magnitude a ranks above magnitude b; a NaN above every number
__device__ __forceinline__ bool above(float a, float b) {
  return (a != a) ? (b == b) : (a > b);
}

__device__ __forceinline__ bool same(float a, float b) {
  return (a != a) ? (b != b) : (a == b);
}

__global__ void topk_compress_kernel(const float* __restrict__ g,
                                     float* __restrict__ vals,
                                     int32_t* __restrict__ idx, int64_t m, int d,
                                     int k) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= m) return;
  const float* row = g + r * d;
  float prev_mag = 0.0f;
  int prev = -1;
  for (int p = 0; p < k; ++p) {
    float best_mag = 0.0f;
    int best = -1;
    for (int c = 0; c < d; ++c) {
      const float mag = fabsf(row[c]);
      // only entries ranking after the previous pick are left
      if (prev >= 0 && !(above(prev_mag, mag) || (same(prev_mag, mag) && c > prev))) {
        continue;
      }
      if (best < 0 || above(mag, best_mag)) {
        best = c;
        best_mag = mag;
      }
    }
    vals[r * k + p] = row[best];
    idx[r * k + p] = best;
    prev = best;
    prev_mag = best_mag;
  }
}

}  // namespace

// Needs 0 < k <= d (the wrapper checks); launches on `stream` and returns
// cudaGetLastError().
extern "C" int topk_compress_launch(const void* g, void* vals, void* idx, int64_t m,
                                    int d, int k, void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  topk_compress_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(vals),
      static_cast<int32_t*>(idx), m, d, k);
  return static_cast<int>(cudaGetLastError());
}
