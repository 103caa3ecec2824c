// FM second-order backward: d/dfields of fm_interaction,
//   out[b, f, :] = g[b] * (sum_f' v[b, f', :] - v[b, f, :]),
// from fields [B, F, D] and the cotangent g [B, 1] to [B, F, D].
//
// Replaces fm_interaction_bwd_pallas (src/repro/kernels/interaction_bwd.py:43).
//
// Bound: bytes. Each sample's F*D floats are read once and F*D written
// once, for about 3 flops each. The TPU kernel reduces a padded batch tile
// of [block_b, F, D] in VMEM. At the training path's shape (B = 256
// samples of 39 x 10) a call is a few microseconds of latency, so the
// design cuts round trips, fills the card and keeps every lane busy:
//  - a block owns `spb` consecutive samples (ops.fm_bwd_plan: at least one
//    block an SM where the batch allows, at most 16 KB of samples, at least
//    64 floats of them, a count whose outputs are whole float4s where one
//    is) and copies their contiguous spb*F*D floats into shared memory with
//    cp.async in one round trip (fm_stage.cuh, as the forward does), with
//    their spb cotangents and every division of the index arithmetic below
//    done meanwhile;
//  - one thread a (sample, column) sums the column over ascending f from
//    +0.0f with plain adds, as the kernel this replaced did, into shared
//    memory;
//  - then every thread of the block walks the block's outputs, consecutive
//    threads on consecutive floats, 16-byte stores where the output range
//    is aligned (a scalar head and tail around them; the input and output
//    ranges are aligned independently), tracking (sample, column) by
//    32-bit steps rather than a division an element. Products and
//    differences round on their own (__fmul_rn, __fsub_rn: no FMA
//    contraction), as in the reference's `g * (s - v)`, so the output is
//    bit for bit the earlier kernel's.
// Where one sample with its sums passes the 48 KB of shared memory a block
// gets unasked, or is under 16 bytes (nothing for a 16-byte copy), the plan
// sets `staged` to 0: a thread owns a (sample, column), sums it through the
// read-only cache in the same order and writes the column's F outputs.
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_stage.cuh"

namespace {

constexpr int kSmemBytes = 48 * 1024;

// out[e] of the block's range for e at sample s, column c
__device__ __forceinline__ float fm_grad(const float* gs, const float* sums, const float* sx,
                                         int e, int s, int c, int d) {
  return __fmul_rn(gs[s], __fsub_rn(sums[s * d + c], sx[e]));
}

__global__ void fm_interaction_bwd_kernel_staged(const float* __restrict__ x,
                                                 const float* __restrict__ g,
                                                 float* __restrict__ out, int64_t b, int f,
                                                 int d, int spb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * spb;
  const int cnt = static_cast<int>(b - s0 < spb ? b - s0 : spb);
  const int fd = f * d, total = cnt * fd;
  const int t = threadIdx.x, nt = blockDim.x;
  float* os = out + s0 * fd;
  // shared: the staged samples (spb*F*D + 3 floats), their column sums
  // (spb*D) and their cotangents (spb)
  const float* sx = fm_stage_issue(smem, x + s0 * fd, total);
  float* sums = smem + spb * fd + 3;
  float* gs = sums + spb * d;
  const float gv = t < cnt ? __ldg(g + s0 + t) : 0.0f;  // the plan keeps spb <= threads
  // every division of the index arithmetic, while the copies are in flight:
  // the first (sample, column) pair of this thread's sums and its stride;
  // the output range's scalar head and tail and 16-byte middle; the
  // (sample, float in sample, column) of this thread's first float4 and
  // of its stride
  int ps = t / d, pc = t - ps * d;
  const int pds = nt / d, pdc = nt - pds * d;
  const int lead = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(os) & 15u)) & 15u) >> 2);
  const int head = lead < total ? lead : total;
  const int n4 = (total - head) >> 2;
  const int tail = head + 4 * n4;
  const int es = t < head ? t : tail + t - head;  // a scalar of the head, then the tail
  const int ss = es / fd, sc = (es - ss * fd) % d;
  const int step = 4 * nt;
  const int ds = step / fd, dr = step - ds * fd, dc = dr % d;
  int e = head + 4 * t;
  int s = e / fd, r = e - s * fd, c = r % d;
  if (t < cnt) gs[t] = gv;
  fm_stage_wait();
  __syncthreads();
  for (int p = t; p < cnt * d; p += nt) {
    const float* col = sx + ps * fd + pc;
    float sum = 0.0f;
#pragma unroll 8
    for (int k = 0; k < f; ++k) sum += col[k * d];
    sums[p] = sum;
    ps += pds;
    pc += pdc;
    if (pc >= d) {
      pc -= d;
      ++ps;
    }
  }
  __syncthreads();
  if (t < head + total - tail) os[es] = fm_grad(gs, sums, sx, es, ss, sc, d);
  for (int q = t; q < n4; q += nt) {
    float v[4];
    int qs = s, qr = r, qc = c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = fm_grad(gs, sums, sx, e + i, qs, qc, d);
      if (++qc == d) qc = 0;
      if (++qr == fd) {
        qr = 0;
        ++qs;
      }
    }
    *reinterpret_cast<float4*>(os + e) = make_float4(v[0], v[1], v[2], v[3]);
    e += step;
    s += ds;
    r += dr;
    c += dc;
    if (c >= d) c -= d;
    if (r >= fd) {
      r -= fd;
      ++s;
    }
  }
}

__global__ void fm_interaction_bwd_kernel_direct(const float* __restrict__ x,
                                                 const float* __restrict__ g,
                                                 float* __restrict__ out, int64_t b, int f,
                                                 int d, int spb) {
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * spb;
  const int cnt = static_cast<int>(b - s0 < spb ? b - s0 : spb);
  const int64_t fd = static_cast<int64_t>(f) * d;
  for (int p = threadIdx.x; p < cnt * d; p += blockDim.x) {
    const int s = p / d;
    const int64_t at = (s0 + s) * fd + (p - s * d);
    const float* col = x + at;
    float* ocol = out + at;
    const float gv = __ldg(g + s0 + s);
    float sum = 0.0f;
#pragma unroll 8
    for (int k = 0; k < f; ++k) sum += __ldg(col + static_cast<int64_t>(k) * d);
#pragma unroll 4
    for (int k = 0; k < f; ++k) {
      const int64_t o = static_cast<int64_t>(k) * d;
      ocol[o] = __fmul_rn(gv, __fsub_rn(sum, __ldg(col + o)));
    }
  }
}

}  // namespace

// Launches on `stream` with ops.fm_bwd_plan's (spb, threads, staged);
// staged blocks take (spb*(F*D + D + 1) + 3) floats of shared memory, at
// most 48 KB, and a thread for each sample's cotangent. Returns
// cudaGetLastError() so the caller can raise.
extern "C" int fm_interaction_bwd_launch(const void* x, const void* g, void* out, int64_t b,
                                         int f, int d, int spb, int threads, int staged,
                                         void* stream) {
  if (b <= 0 || f <= 0 || d <= 0 || spb <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || static_cast<int64_t>(spb) * f * d > (1 << 28) ||
      (staged && spb > threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (b + spb - 1) / spb;
  const size_t smem = (static_cast<size_t>(spb) * (f * d + d + 1) + 3) * sizeof(float);
  if (blocks > 0x7fffffff || (staged && smem > static_cast<size_t>(kSmemBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  if (staged) {
    fm_interaction_bwd_kernel_staged<<<static_cast<unsigned int>(blocks), threads, smem, st>>>(
        xp, gp, op, b, f, d, spb);
  } else {
    fm_interaction_bwd_kernel_direct<<<static_cast<unsigned int>(blocks), threads, 0, st>>>(
        xp, gp, op, b, f, d, spb);
  }
  return static_cast<int>(cudaGetLastError());
}
