// DLRM pairwise dot interaction: [B, F, D] -> [B, P], P = F(F-1)/2,
//   out[b, p(i, j)] = sum_d x[b, i, d] * x[b, j, d]   for i < j,
// with the pairs in np.triu_indices(F, k=1) order (row-major).
//
// Replaces dot_interaction_pallas (src/repro/kernels/dot_interaction.py:37).
//
// Bound: bytes at the path's shapes (B*F*D floats read once, B*P written
// once; the 2*B*P*D flops sit 3-4x below at float32 rates). The TPU kernel
// forms the full X X^T on the MXU and extracts the triangle with a [F*F, P]
// 0/1 selection matmul, because gathers are slow on its vector unit. Here a
// block stages its samples' [F, D] rows in shared memory (each row padded to
// an odd stride, so threads reading different rows at the same column hit
// different banks) and one thread computes one pair's dot, summing d in
// increasing order with fused multiply-adds: no selection matrix, no
// [F, F] intermediate, no atomics, so the result repeats bit for bit. The
// pair table (i, j) of the triangle is decoded once per block into shared
// memory. Consecutive threads take consecutive pairs of a sample, so the
// output rows are written coalesced. A block takes several samples when one
// sample has fewer pairs than the block has threads (small F).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in needed below this

__global__ void dot_interaction_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int64_t b,
                                       int f, int d, int stride, int p_count,
                                       int per_block) {
  extern __shared__ float smem[];
  int* pairs = reinterpret_cast<int*>(smem);  // [P]: i << 16 | j
  float* xs = smem + p_count;                 // [per_block, F, stride]
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int ns = static_cast<int>(b - b0 < per_block ? b - b0 : per_block);

  for (int p = threadIdx.x; p < p_count; p += blockDim.x) {
    int i = 0, r = p;
    while (r >= f - 1 - i) {  // row i of the triangle holds F-1-i pairs
      r -= f - 1 - i;
      ++i;
    }
    pairs[p] = (i << 16) | (i + 1 + r);
  }
  const int fd = f * d;
  const float* xb = x + b0 * fd;
  for (int e = threadIdx.x; e < ns * fd; e += blockDim.x) {
    const int row = e / d;  // sample * F + field
    xs[row * stride + (e - row * d)] = xb[e];
  }
  __syncthreads();

  float* ob = out + b0 * p_count;
  for (int t = threadIdx.x; t < ns * p_count; t += blockDim.x) {
    const int s = t / p_count;
    const int ij = pairs[t - s * p_count];
    const float* xi = xs + (s * f + (ij >> 16)) * stride;
    const float* xj = xs + (s * f + (ij & 0xffff)) * stride;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(xi[k], xj[k], acc);
    ob[t] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
// The wrapper has checked that the pair table and one sample's padded rows
// fit in 48 KB, and launches only for B > 0, F > 1 and D > 0.
extern "C" int dot_interaction_launch(const void* x, void* out, int64_t b, int f,
                                      int d, void* stream) {
  const int stride = d | 1;
  const int p_count = f * (f - 1) / 2;
  if (b <= 0 || p_count <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int sample_bytes = f * stride * 4;
  int per_block = (kThreads + p_count - 1) / p_count;
  const int fit = (kSmemBytes - p_count * 4) / sample_bytes;
  if (per_block > fit) per_block = fit;
  if (per_block < 1) per_block = 1;
  const int64_t blocks = (b + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(p_count) * 4 +
                      static_cast<size_t>(per_block) * sample_bytes;
  dot_interaction_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), b, f, d, stride,
      p_count, per_block);
  return static_cast<int>(cudaGetLastError());
}
