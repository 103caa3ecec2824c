// Staging of a block's consecutive FM samples into shared memory, shared by
// the forward (fm_interaction.cu) and the backward (fm_interaction_bwd.cu).
//
// A block's samples are one contiguous range of `total` floats of `x`. Every
// copy is a cp.async, all in flight before any is waited for: one round
// trip to device memory. 16-byte copies (L2 only) cover the range's
// 16-byte-aligned middle, 4-byte ones its head and tail (a deepfm sample is
// 1,560 bytes, so every other block starts 8 bytes off a 16-byte
// boundary). The buffer holds total + 3 floats; the returned pointer is
// shifted into it so that the range's first 16-byte-aligned float lands on
// a 16-byte boundary of shared memory too, and element e of the range is
// at ret[e].
#pragma once
#include <cstdint>

namespace {

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Issues the copies of src[0, total) into `buf` (16-byte aligned, total + 3
// floats) by the block's threads; returns where src[0] lands. The caller
// waits with fm_stage_wait() and then synchronises the block.
__device__ __forceinline__ float* fm_stage_issue(float* buf, const float* src, int total) {
  const int lead = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2);
  const int head = lead < total ? lead : total;
  float* sm = buf + ((4 - head) & 3);
  const int n4 = (total - head) >> 2;
  const int tail = head + 4 * n4;
  for (int e = threadIdx.x; e < n4; e += blockDim.x) {
    cp16(sm + head + 4 * e, src + head + 4 * e);
  }
  if (static_cast<int>(threadIdx.x) < head) cp4(sm + threadIdx.x, src + threadIdx.x);
  if (static_cast<int>(threadIdx.x) < total - tail) {
    cp4(sm + tail + threadIdx.x, src + tail + threadIdx.x);
  }
  return sm;
}

__device__ __forceinline__ void fm_stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
