// Fused cache-tier probe for the HybridHash L1 tier.
//
// Replaces tier_probe_pallas (src/repro/kernels/fused_embedding.py:279).
// Per query u: slot = min(#(keys < u), H - 1) over the sorted tier keys,
// hit = keys[slot] == u && uvalid, and the hit row of the tier (exact zeros
// on a miss), so the caller's stitch is one `where`.
//
// Bound: bytes and latency. Each query reads ~log2(H) keys, one D-float row
// on a hit, and writes 1 + 4 + 4*D bytes; there is no arithmetic to speak
// of. The TPU kernel ranks by counting over the whole key vector held in
// VMEM, O(n*H); here each thread runs a real binary search in device memory
// (at H = 4,194,304 the int32 keys are 16 MB and stay in the 50 MB L2). The
// row copy is done by the whole block afterwards, one float per thread, so
// neighbouring threads read and write neighbouring addresses instead of each
// thread striding over its own D floats.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tier_probe_kernel(const int32_t* __restrict__ uniq,
                                  const uint8_t* __restrict__ uvalid,
                                  const int32_t* __restrict__ keys,
                                  const float* __restrict__ rows,
                                  uint8_t* __restrict__ hit_out,
                                  int32_t* __restrict__ slot_out,
                                  float* __restrict__ rows_out,
                                  int64_t n, int64_t h, int d) {
  __shared__ int32_t s_slot[kThreads];
  __shared__ uint8_t s_hit[kThreads];
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t q = q0 + threadIdx.x;
  if (q < n) {
    const int32_t u = uniq[q];
    int64_t lo = 0, hi = h;  // lower bound: first key >= u
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (keys[mid] < u) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t slot = lo < h - 1 ? lo : h - 1;
    const uint8_t hit = (uvalid[q] != 0 && keys[slot] == u) ? 1 : 0;
    hit_out[q] = hit;
    slot_out[q] = static_cast<int32_t>(slot);
    s_slot[threadIdx.x] = static_cast<int32_t>(slot);
    s_hit[threadIdx.x] = hit;
  }
  __syncthreads();
  const int64_t nq = (n - q0) < kThreads ? (n - q0) : kThreads;
  for (int64_t e = threadIdx.x; e < nq * d; e += kThreads) {
    const int64_t i = e / d;
    const int64_t c = e - i * d;
    rows_out[(q0 + i) * d + c] =
        s_hit[i] ? rows[static_cast<int64_t>(s_slot[i]) * d + c] : 0.0f;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int tier_probe_launch(const void* uniq, const void* uvalid,
                                 const void* keys, const void* rows, void* hit,
                                 void* slot, void* rows_out, int64_t n,
                                 int64_t h, int d, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  tier_probe_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(uniq), static_cast<const uint8_t*>(uvalid),
      static_cast<const int32_t*>(keys), static_cast<const float*>(rows),
      static_cast<uint8_t*>(hit), static_cast<int32_t*>(slot),
      static_cast<float*>(rows_out), n, h, d);
  return static_cast<int>(cudaGetLastError());
}
