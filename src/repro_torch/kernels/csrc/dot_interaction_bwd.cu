// DLRM pairwise dot interaction backward: d/dfields of dot_interaction,
//   out[b, i, :] = sum_{j != i} G[i, j] * x[b, j, :],
//   G[i, j] = g[b, p(min(i, j), max(i, j))],
// from fields [B, F, D] and the cotangent g [B, P] to [B, F, D]; p(i, j) is
// the np.triu_indices(F, k=1) position of the pair. This is the reference's
// (gZ + gZ^T) @ x with gZ the cotangent scattered into the strict upper
// triangle.
//
// Replaces dot_interaction_bwd_pallas (src/repro/kernels/interaction_bwd.py:89).
//
// Bound: bytes (B*F*D floats read and written once, B*P read once; the
// 2*B*F*F*D flops sit below at float32 rates). The TPU kernel scatters g
// into a [F, F] block with the transpose of a [P, F*F] 0/1 selection matmul
// and then multiplies on the MXU. Here a block stages its samples' [F, D]
// rows and the symmetric [F, F] G (zero diagonal) in shared memory, and one
// thread owns one output element (i, d), summing over j in increasing order
// (j = i skipped) with fused multiply-adds: no selection matrix, nothing
// [F, F] in device memory, no atomics, so the result repeats bit for bit.
// Consecutive threads take consecutive d of a row, so both the shared reads
// of x and the output writes are contiguous, and G[i, j] is a broadcast. A
// block takes several samples when one sample has fewer elements than the
// block has threads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in needed below this

__global__ void dot_interaction_bwd_kernel(const float* __restrict__ x,
                                           const float* __restrict__ g,
                                           float* __restrict__ out, int64_t b,
                                           int f, int d, int p_count,
                                           int per_block) {
  extern __shared__ float smem[];
  const int fd = f * d, ff = f * f;
  float* xs = smem;                   // [per_block, F, D]
  float* gs = smem + per_block * fd;  // [per_block, F, F]
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int ns = static_cast<int>(b - b0 < per_block ? b - b0 : per_block);

  const float* xb = x + b0 * fd;
  for (int e = threadIdx.x; e < ns * fd; e += blockDim.x) xs[e] = xb[e];
  const float* gb = g + b0 * p_count;
  for (int e = threadIdx.x; e < ns * ff; e += blockDim.x) {
    const int s = e / ff;
    const int r = e - s * ff;
    const int i = r / f;
    const int j = r - i * f;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    // row lo of the triangle starts at lo*F - lo*(lo+1)/2
    gs[e] = lo == hi ? 0.0f
                     : gb[static_cast<int64_t>(s) * p_count + lo * f - lo * (lo + 1) / 2 +
                          (hi - lo - 1)];
  }
  __syncthreads();

  float* ob = out + b0 * fd;
  for (int t = threadIdx.x; t < ns * fd; t += blockDim.x) {
    const int s = t / fd;
    const int r = t - s * fd;
    const int i = r / d;
    const int k = r - i * d;
    const float* gi = gs + s * ff + i * f;
    const float* xk = xs + s * fd + k;
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) {
      if (j != i) acc = fmaf(gi[j], xk[j * d], acc);
    }
    ob[t] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
// The wrapper has checked that one sample's rows and G fit in 48 KB, and
// launches only for B > 0, F > 0 and D > 0.
extern "C" int dot_interaction_bwd_launch(const void* x, const void* g, void* out,
                                          int64_t b, int f, int d, void* stream) {
  if (b <= 0 || f <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int p_count = f * (f - 1) / 2;
  const int sample_bytes = (f * d + f * f) * 4;
  int per_block = (kThreads + f * d - 1) / (f * d);
  const int fit = kSmemBytes / sample_bytes;
  if (per_block > fit) per_block = fit;
  if (per_block < 1) per_block = 1;
  const int64_t blocks = (b + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(per_block) * sample_bytes;
  dot_interaction_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(out), b, f, d, p_count, per_block);
  return static_cast<int>(cudaGetLastError());
}
