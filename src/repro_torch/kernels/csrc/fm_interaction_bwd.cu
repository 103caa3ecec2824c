// FM second-order backward: d/dfields of fm_interaction,
//   out[b, f, :] = g[b] * (sum_f' v[b, f', :] - v[b, f, :]),
// from fields [B, F, D] and the cotangent g [B, 1] to [B, F, D].
//
// Replaces fm_interaction_bwd_pallas (src/repro/kernels/interaction_bwd.py:43).
//
// Bound: bytes. Each sample's F*D floats are read once and F*D written
// once, for about 3 flops each. The TPU kernel reduces a padded batch tile
// of [block_b, F, D] in VMEM. Here one warp owns one sample, like the
// forward (fm_interaction.cu): lane c keeps the column sum for embedding
// column c in a register (columns c, c+32, ... when D > 32), reading the
// sample's rows as contiguous 4*D-byte runs, then writes the F outputs of
// its column. The second pass re-reads the sample's rows from L1. Rows past
// B are never touched: no padding. Products and differences round on their
// own (no FMA contraction), as in the reference's `g * (s - v)`.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void fm_interaction_bwd_kernel(const float* __restrict__ x,
                                          const float* __restrict__ g,
                                          float* __restrict__ out, int64_t b,
                                          int f, int d) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (s >= b) return;
  const float* xs = x + s * f * d;
  float* os = out + s * f * d;
  const float gs = g[s];
  for (int c = lane; c < d; c += 32) {
    float sum = 0.0f;
    for (int k = 0; k < f; ++k) sum += xs[static_cast<int64_t>(k) * d + c];
    for (int k = 0; k < f; ++k) {
      const int64_t e = static_cast<int64_t>(k) * d + c;
      os[e] = __fmul_rn(gs, __fsub_rn(sum, xs[e]));
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int fm_interaction_bwd_launch(const void* x, const void* g, void* out,
                                         int64_t b, int f, int d, void* stream) {
  const int64_t blocks = (b + kWarps - 1) / kWarps;
  fm_interaction_bwd_kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(out), b, f, d);
  return static_cast<int>(cudaGetLastError());
}
