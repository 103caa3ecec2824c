// FM second-order interaction: [B, F, D] -> [B, 1],
//   out[b] = 0.5 * sum_d((sum_f v)^2 - sum_f v^2).
//
// Replaces fm_interaction_pallas (src/repro/kernels/fm_interaction.py:24).
//
// Bound: bytes. Each sample's F*D floats are read once for about 3 flops
// each. The TPU kernel reduces a padded batch tile of [block_b, F, D] in
// VMEM. At the paths' shapes (B = 256 or 512 samples of 39 x 10) a call is
// a few microseconds of latency, far from the byte bound, so the design
// cuts round trips and fills the card:
//  - a block owns `spb` consecutive samples, a warp each (ops.fm_plan: at
//    least one block an SM where the batch allows; at most eight samples
//    and 16 KB a block) and copies their contiguous spb*F*D floats into
//    shared memory with cp.async in one round trip (fm_stage.cuh);
//  - then one warp reduces one sample at a time as the kernel this replaced
//    did straight from device memory: lane c keeps sum_f v and sum_f v^2 of
//    column c (c, c + 32, ... when D > 32), ascending f from +0.0f with
//    v * v fused into the sum (fmaf, the contraction that -O3 made of
//    `sq += v * v`), adds fmaf(sum, sum, -sq), and a shuffle tree reduces
//    over the lanes, so the output is bit for bit the earlier kernel's.
// Where one sample alone exceeds the 48 KB of shared memory a block gets
// unasked, the plan sets `staged` to 0: each warp reads its sample from
// device memory directly, through the read-only cache, as the earlier
// kernel did.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_stage.cuh"

namespace {

// One sample's FM term by one warp, from shared memory (kStaged) or
// through the read-only cache; the result is whole on lane 0.
template <bool kStaged>
__device__ __forceinline__ float fm_sample(const float* xs, int f, int d, int lane) {
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    float sum = 0.0f, sq = 0.0f;
#pragma unroll (kStaged ? 4 : 8)
    for (int k = 0; k < f; ++k) {
      const float* at = xs + static_cast<int64_t>(k) * d + c;
      const float v = kStaged ? *at : __ldg(at);
      sum += v;
      sq = fmaf(v, v, sq);
    }
    acc += fmaf(sum, sum, -sq);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  return acc;
}

template <bool kStaged>
__global__ void fm_interaction_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      int64_t b, int f, int d, int spb) {
  extern __shared__ float4 smem4[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * spb;
  const int cnt = static_cast<int>(b - s0 < spb ? b - s0 : spb);
  const int64_t fd = static_cast<int64_t>(f) * d;
  const float* xs = x + s0 * fd;
  if (kStaged) {
    // the plan keeps the block's spb*F*D floats (+ 3 of shift) within 48 KB
    xs = fm_stage_issue(reinterpret_cast<float*>(smem4), xs, static_cast<int>(cnt * fd));
    fm_stage_wait();
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < cnt; s += blockDim.x >> 5) {  // whole warps
    const float acc = fm_sample<kStaged>(xs + s * fd, f, d, lane);
    if (lane == 0) out[s0 + s] = 0.5f * acc;
  }
}

}  // namespace

// Launches on `stream` with ops.fm_plan's (spb, threads, staged); staged
// blocks take (spb*F*D + 3) floats of shared memory, at most 48 KB.
// Returns cudaGetLastError() so the caller can raise.
extern "C" int fm_interaction_launch(const void* x, void* out, int64_t b, int f, int d,
                                     int spb, int threads, int staged, void* stream) {
  if (b <= 0 || f < 0 || d < 0 || spb <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || (staged && static_cast<int64_t>(spb) * f * d + 3 > 12 * 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (b + spb - 1) / spb;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (staged) {
    const size_t smem = (static_cast<size_t>(spb) * f * d + 3) * sizeof(float);
    fm_interaction_kernel<true><<<static_cast<unsigned int>(blocks), threads, smem, st>>>(
        xp, op, b, f, d, spb);
  } else {
    fm_interaction_kernel<false><<<static_cast<unsigned int>(blocks), threads, 0, st>>>(
        xp, op, b, f, d, spb);
  }
  return static_cast<int>(cudaGetLastError());
}
