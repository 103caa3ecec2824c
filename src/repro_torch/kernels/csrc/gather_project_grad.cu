// Transpose of gather_project with respect to the routed-back buffer:
//   g_back[j] = sum over kept i with idx[i] = j of
//               (g_wide[i] @ proj^T + g_narrow[i]),     g_back: [m, d].
//
// Replaces gather_project_grad_pallas
// (src/repro/kernels/fused_embedding.py:412). The TPU wrapper appends one
// zero "ghost" position per slot, argsorts everything by slot and
// run-accumulates into the sequential grid's output block, so every slot is
// written. Here the wrapper stable-sorts the slots once (not-kept positions
// and slots outside [0, m) take the sentinel m, which sorts last and is
// dropped); a CSR pass finds each slot's run, and one
// thread per (slot, k) walks its run in sorted (= original position) order
// with proj in shared memory, folding each position's wide cotangent
// through proj^T over c = 0..D-1 in order. A slot with an empty run comes
// out exactly 0 without ghosts; there are no atomics, so the result
// repeats bit for bit.
//
// Bound: bytes. Per kept position it reads D + d floats of cotangent and
// the sort's order and slot, and per slot it writes d floats; 2*d*D + d
// flops a position, far below the float32 rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The CSR pass: slots in (idx[i-1], idx[i]] start at sorted position i
// (idx[-1] = -1); slots in (idx[n-1], m] start at n. Thread t does both
// jobs for position t and slot t, so the grid covers max(n, m + 1)
// threads. Slots outside [0, m) are clamped away: such positions fall
// outside every run.
__global__ void csr_offsets_kernel(const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ offsets, int32_t n, int32_t m) {
  const int32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t < n) {
    const int32_t prev = t == 0 ? -1 : idx[t - 1];
    const int32_t cur = idx[t];
    const int32_t hi = cur < m ? cur : m;
    for (int32_t b = prev + 1 > 0 ? prev + 1 : 0; b <= hi; ++b) offsets[b] = t;
  }
  const int32_t last = n > 0 ? idx[n - 1] : -1;
  if (t <= m && t > last) offsets[t] = n;
}

__global__ void gather_project_grad_kernel(const float* __restrict__ g_wide,
                                           const float* __restrict__ g_narrow,
                                           const float* __restrict__ proj,
                                           const int64_t* __restrict__ order,
                                           const int32_t* __restrict__ offsets,
                                           float* __restrict__ out, int32_t m,
                                           int nd, int d) {
  extern __shared__ float s_proj[];  // [nd, d]
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < nd * d; e += nthreads) s_proj[e] = proj[e];
  __syncthreads();
  const int32_t o = blockIdx.x * blockDim.y + threadIdx.y;
  const int k = threadIdx.x;
  if (o >= m) return;
  const float* pk = s_proj + k * d;
  const int32_t end = offsets[o + 1];
  float acc = 0.0f;
  for (int32_t i = offsets[o]; i < end; ++i) {
    const int64_t p = order[i];
    const float* gw = g_wide + p * d;
    float fold = 0.0f;
    for (int c = 0; c < d; ++c) fold = fmaf(gw[c], pk[c], fold);
    acc += fold + g_narrow[p * nd + k];
  }
  out[static_cast<int64_t>(o) * nd + k] = acc;
}

}  // namespace

// `sorted_idx` is the slots (sentinel m where not kept) sorted ascending and
// `order` (int64) the stable sort's permutation; `offsets` is int32 scratch
// of m + 1. Needs n, m < 2^31, 0 < nd <= 256 and nd * d floats of shared
// memory within 48 KB (the wrapper checks). Returns cudaGetLastError() so
// the caller can raise.
extern "C" int gather_project_grad_launch(const void* g_wide, const void* g_narrow,
                                          const void* proj, const void* order,
                                          const void* sorted_idx, void* offsets,
                                          void* out, int64_t n, int64_t m,
                                          int nd, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t n32 = static_cast<int32_t>(n), m32 = static_cast<int32_t>(m);
  const int64_t threads = n > m + 1 ? n : m + 1;
  csr_offsets_kernel<<<
      static_cast<unsigned int>((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const int32_t*>(sorted_idx), static_cast<int32_t*>(offsets), n32,
      m32);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows_per_block = nd >= kThreads ? 1 : kThreads / nd;
  const dim3 block(nd, rows_per_block);
  const unsigned int blocks =
      static_cast<unsigned int>((m + rows_per_block - 1) / rows_per_block);
  const size_t smem = static_cast<size_t>(nd) * d * sizeof(float);
  gather_project_grad_kernel<<<blocks, block, smem, s>>>(
      static_cast<const float*>(g_wide), static_cast<const float*>(g_narrow),
      static_cast<const float*>(proj), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(offsets), static_cast<float*>(out), m32, nd, d);
  return static_cast<int>(cudaGetLastError());
}
