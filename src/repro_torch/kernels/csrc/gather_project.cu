// Narrow-row stitch of the picasso_narrow lookup: gather the [d]-narrow rows
// out of the routed-back buffer and project them up through the learned
// [d, D] map,
//   narrow[i] = ok(i) ? back[idx[i]] : 0,   wide[i] = narrow[i] @ proj,
// with ok(i) = kept[i] && 0 <= idx[i] < m; both outputs are exact zeros
// where ok(i) is false.
//
// Replaces gather_project_pallas (src/repro/kernels/fused_embedding.py:351),
// which runs one grid step per position: a DMA of the narrow row, then an
// MXU product with the VMEM-resident projection.
//
// Bound: bytes. Per position it reads idx, kept and d floats of `back`, and
// writes D + d floats; 2*d*D flops, far below the float32 rate. A block
// takes kRows positions: it stages proj (d*D floats) and its kRows narrow
// rows in shared memory, writing the narrow output on the way, then each
// thread computes (position, column) elements of `wide`, summing over
// k = 0..d-1 in order. Threads walk the flat element index, so
// neighbouring threads write neighbouring addresses of both outputs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;

__global__ void gather_project_kernel(const float* __restrict__ back,
                                      const int32_t* __restrict__ idx,
                                      const uint8_t* __restrict__ kept,
                                      const float* __restrict__ proj,
                                      float* __restrict__ wide,
                                      float* __restrict__ narrow, int64_t m,
                                      int64_t n, int nd, int d) {
  extern __shared__ float smem[];
  float* s_proj = smem;              // [nd, d]
  float* s_rows = smem + nd * d;     // [kRows, nd]
  __shared__ uint8_t s_ok[kRows];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>((n - p0) < kRows ? (n - p0) : kRows);

  for (int e = threadIdx.x; e < nd * d; e += kThreads) s_proj[e] = proj[e];
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int32_t j = idx[p0 + i];
    s_ok[i] = (kept[p0 + i] != 0 && j >= 0 && j < m) ? 1 : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * nd; e += kThreads) {
    const int i = e / nd;
    const int k = e - i * nd;
    const float v =
        s_ok[i] ? back[static_cast<int64_t>(idx[p0 + i]) * nd + k] : 0.0f;
    s_rows[e] = v;
    narrow[p0 * nd + e] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    float acc = 0.0f;
    if (s_ok[i]) {
      const float* r = s_rows + i * nd;
      for (int k = 0; k < nd; ++k) acc = fmaf(r[k], s_proj[k * d + c], acc);
    }
    wide[p0 * d + e] = acc;
  }
}

}  // namespace

// Launches on `stream`. Needs n < 2^31 blocks' worth of positions and
// (nd * d + kRows * nd) floats of shared memory within 48 KB (the wrapper
// checks). Returns cudaGetLastError() so the caller can raise.
extern "C" int gather_project_launch(const void* back, const void* idx,
                                     const void* kept, const void* proj,
                                     void* wide, void* narrow, int64_t m,
                                     int64_t n, int nd, int d, void* stream) {
  const int64_t blocks = (n + kRows - 1) / kRows;
  const size_t smem = static_cast<size_t>(nd * d + kRows * nd) * sizeof(float);
  gather_project_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(back), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(kept), static_cast<const float*>(proj),
      static_cast<float*>(wide), static_cast<float*>(narrow), m, n, nd, d);
  return static_cast<int>(cudaGetLastError());
}
