// Routed-gradient fp16 decompression: out[r, c] = float(q[r, c]) * s[r] for
// q [m, D] (half) and s [m, 1] (float32).
//
// Replaces fp16_decompress_pallas (src/repro/kernels/grad_compress.py:65).
//
// Bound: bytes (2 bytes in and 4 out for one multiply an element). The TPU
// kernel scales a [256, D] block in VMEM. The earlier kernel here gave each
// thread one element: a 2-byte load, a 64-bit division for its row and a
// 4-byte store, no access 16 bytes wide. This one takes the flat m * D
// stream in quads of 4 consecutive outputs (16 bytes, aligned on out):
//  - out's first e0 < 4 elements (where out is off 16 bytes) and the last
//    < 4 are a scalar head and tail;
//  - a thread takes quad t, then t + T, ... (T threads in the grid;
//    ops.fp16_decompress_plan gives a thread one quad, or two where the
//    quads pass what the SMs hold at once), so a warp's loads and stores
//    are each one contiguous range: an 8-byte load of 4 halves (two
//    4-byte or four 2-byte loads where q is off 8 bytes there) issued
//    first, and one 16-byte store, the next quad's loads issued before
//    it;
//  - its first quad's row comes from one multiply-high by a magic number
//    the host works out for D (exact for 32-bit offsets), then row and
//    column step by the grid stride's quotient and remainder, which the
//    host divides once; a quad spans at most two rows at D >= 4 (the
//    second row's scale read only where the quad reaches it) and up to
//    four at D < 4 (each element's row walked);
//  - offsets are 32-bit where m * D and the grid stride allow, else
//    64-bit (m * D may pass 2^32), with a 64-bit division a thread.
// On the H100 this ran faster than 8 consecutive outputs a thread at
// deepfm's D = 10, dcn-v2's 16, DLRM's 32 and at bulk, as fast at D = 6
// and 8, and 0.00002 ms slower at the narrow d = 4.
// The half-to-float conversion is exact (__half2float, NaN payloads and
// -0.0 kept as the earlier kernel kept them) and the product is one
// rounded multiply, as in the earlier kernel and the plain version: the
// output is bitwise theirs.
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

// x / d for 0 <= x < 2^31 by a multiply-high: mul = ceil(2^p / d) with
// p = 31 + ceil(log2 d), as CUTLASS's FastDivmod; d = 1 passes x through
struct FastDiv {
  int d;
  uint32_t mul;
  int shr;
  explicit FastDiv(int d_) : d(d_), mul(0), shr(0) {
    if (d_ == 1) return;
    int c = 0;
    while ((int64_t{1} << c) < d_) ++c;
    const int p = 31 + c;
    mul = static_cast<uint32_t>(((uint64_t{1} << p) + d_ - 1) / d_);
    shr = p - 32;
  }
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    return d == 1 ? x : __umulhi(x, mul) >> shr;
  }
};

// four halves at q (aligned to QW bytes), as floats
template <int QW>
__device__ __forceinline__ void load4(const __half* __restrict__ q, float (&h)[4]) {
  if constexpr (QW == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(q);
    const __half2 a = *reinterpret_cast<const __half2*>(&v.x);
    const __half2 b = *reinterpret_cast<const __half2*>(&v.y);
    h[0] = __half2float(__low2half(a));
    h[1] = __half2float(__high2half(a));
    h[2] = __half2float(__low2half(b));
    h[3] = __half2float(__high2half(b));
  } else if constexpr (QW == 4) {
    const __half2 a = *reinterpret_cast<const __half2*>(q);
    const __half2 b = *reinterpret_cast<const __half2*>(q + 2);
    h[0] = __half2float(__low2half(a));
    h[1] = __half2float(__high2half(a));
    h[2] = __half2float(__low2half(b));
    h[3] = __half2float(__high2half(b));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __half2float(q[k]);
  }
}

// the scales of a quad whose first element sits at row r, column c
template <typename I, bool kNarrow>
__device__ __forceinline__ void quad_scales(const float* __restrict__ s, I r, I c, I d,
                                            float (&sc)[4]) {
  if constexpr (!kNarrow) {  // D >= 4: rows r and r + 1 at most
    const float s0 = s[r];
    const float s1 = c + 3 >= d ? s[r + 1] : s0;
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] = c + k < d ? s0 : s1;
  } else {  // D < 4: each element's row
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sc[k] = s[r];
      if (++c == d) {
        c = 0;
        ++r;
      }
    }
  }
}

template <typename I, int QW, bool kNarrow>
__global__ void fp16_decompress_kernel(const __half* __restrict__ q,
                                       const float* __restrict__ s,
                                       float* __restrict__ out, I n, FastDiv fd, I e0,
                                       I quads, I r_step, I c_step) {
  const I d = static_cast<I>(fd.d);
  const I t = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  const I nthreads = static_cast<I>(gridDim.x) * blockDim.x;
  if (t < quads) {
    const I end = e0 + 4 * quads;
    I e = e0 + 4 * t;
    float h[4], sc[4];
    load4<QW>(q + e, h);
    I r;
    if constexpr (sizeof(I) == 4) {
      r = fd.div(e);
    } else {
      r = e / d;
    }
    I c = e - r * d;
    quad_scales<I, kNarrow>(s, r, c, d, sc);
    for (;;) {  // the next quad's loads go out before this quad's store
      const I e_next = e + 4 * nthreads;
      I r_next = r + r_step, c_next = c + c_step;
      if (c_next >= d) {
        c_next -= d;
        ++r_next;
      }
      float h_next[4], sc_next[4];
      if (e_next < end) {
        load4<QW>(q + e_next, h_next);
        quad_scales<I, kNarrow>(s, r_next, c_next, d, sc_next);
      }
      *reinterpret_cast<float4*>(out + e) =
          make_float4(h[0] * sc[0], h[1] * sc[1], h[2] * sc[2], h[3] * sc[3]);
      if (e_next >= end) break;
      e = e_next;
      r = r_next;
      c = c_next;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h[k] = h_next[k];
        sc[k] = sc_next[k];
      }
    }
  }
  const I tail0 = e0 + 4 * quads;
  if (t < e0) out[t] = __half2float(q[t]) * s[t / d];
  if (t < n - tail0) out[tail0 + t] = __half2float(q[tail0 + t]) * s[(tail0 + t) / d];
}

template <typename I, int QW, bool kNarrow>
void launch(const void* q, const void* s, void* out, int64_t n, int d, int64_t e0,
            int64_t quads, int blocks, int threads, cudaStream_t st) {
  const int64_t step = 4 * static_cast<int64_t>(blocks) * threads;
  fp16_decompress_kernel<I, QW, kNarrow><<<blocks, threads, 0, st>>>(
      static_cast<const __half*>(q), static_cast<const float*>(s), static_cast<float*>(out),
      static_cast<I>(n), FastDiv(d), static_cast<I>(e0),
      static_cast<I>(quads), static_cast<I>(step / d), static_cast<I>(step % d));
}

template <typename I, bool kNarrow>
void launch_width(int qw, const void* q, const void* s, void* out, int64_t n, int d,
                  int64_t e0, int64_t quads, int blocks, int threads, cudaStream_t st) {
  if (qw == 8)
    launch<I, 8, kNarrow>(q, s, out, n, d, e0, quads, blocks, threads, st);
  else if (qw == 4)
    launch<I, 4, kNarrow>(q, s, out, n, d, e0, quads, blocks, threads, st);
  else
    launch<I, 2, kNarrow>(q, s, out, n, d, e0, quads, blocks, threads, st);
}

}  // namespace

// n = m * D elements; `blocks` x `threads` from ops.fp16_decompress_plan
// (threads a multiple of 32, at least 32, so the first block covers the head
// and tail). q and out need only their types' alignment. Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int fp16_decompress_launch(const void* q, const void* s, void* out, int64_t n,
                                      int d, int blocks, int threads, void* stream) {
  if (n <= 0 || d <= 0 || n % d != 0 || blocks <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t oaddr = reinterpret_cast<uintptr_t>(out);
  int64_t e0 = static_cast<int64_t>((16 - (oaddr & 15)) & 15) / 4;
  if (e0 > n) e0 = n;
  const int64_t quads = (n - e0) / 4;
  // q's alignment at the first quad fixes every quad's: they lie 8 bytes apart
  const uintptr_t qoff = (reinterpret_cast<uintptr_t>(q) + 2 * e0) & 7;
  const int qw = qoff == 0 ? 8 : (qoff % 4 == 0 ? 4 : 2);
  // 32-bit offsets where every offset a thread forms (up to n plus a grid
  // stride) stays below 2^31
  const bool small = n + 8 * static_cast<int64_t>(blocks) * threads < (int64_t{1} << 31);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small && d >= 4)
    launch_width<uint32_t, false>(qw, q, s, out, n, d, e0, quads, blocks, threads, st);
  else if (small)
    launch_width<uint32_t, true>(qw, q, s, out, n, d, e0, quads, blocks, threads, st);
  else if (d >= 4)
    launch_width<int64_t, false>(qw, q, s, out, n, d, e0, quads, blocks, threads, st);
  else
    launch_width<int64_t, true>(qw, q, s, out, n, d, e0, quads, blocks, threads, st);
  return static_cast<int>(cudaGetLastError());
}
