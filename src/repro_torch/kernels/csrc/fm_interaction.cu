// FM second-order interaction: [B, F, D] -> [B, 1],
//   out[b] = 0.5 * sum_d((sum_f v)^2 - sum_f v^2).
//
// Replaces fm_interaction_pallas (src/repro/kernels/fm_interaction.py:24).
//
// Bound: bytes. Each sample's F*D floats are read once for about 3 flops
// each. The TPU kernel reduces a padded batch tile of [block_b, F, D] in
// VMEM. Here one warp owns one sample: lane c keeps sum_f v and sum_f v^2
// for embedding column c in registers (columns c, c+32, ... when D > 32),
// reading the sample's rows as contiguous 4*D-byte runs; a warp shuffle
// then reduces over d. Rows past B are never touched: no padding.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void fm_interaction_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, int64_t b,
                                      int f, int d) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (s >= b) return;  // the whole warp leaves together
  const float* xs = x + s * f * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    float sum = 0.0f, sq = 0.0f;
    for (int k = 0; k < f; ++k) {
      const float v = xs[static_cast<int64_t>(k) * d + c];
      sum += v;
      sq += v * v;
    }
    acc += sum * sum - sq;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[s] = 0.5f * acc;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int fm_interaction_launch(const void* x, void* out, int64_t b, int f,
                                     int d, void* stream) {
  const int64_t blocks = (b + kWarps - 1) / kWarps;
  fm_interaction_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), b, f, d);
  return static_cast<int>(cudaGetLastError());
}
