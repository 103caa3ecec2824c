// Transpose of gather_project with respect to the routed-back buffer:
//   g_back[j] = sum over kept i with idx[i] = j of
//               (g_wide[i] @ proj^T + g_narrow[i]),     g_back: [m, d].
//
// Replaces gather_project_grad_pallas
// (src/repro/kernels/fused_embedding.py:412). The TPU wrapper appends one
// zero "ghost" position per slot, argsorts everything by slot and
// run-accumulates into the sequential grid's output block, so every slot is
// written.
//
// Bound: bytes. Per kept position it reads D + d floats of cotangent, and
// per slot it writes d floats; 2*d*D + d flops a position, far below the
// float32 rate. On the narrow path (n = 9,984 positions, m = 15,976 slots,
// d = 4, D = 10) the bytes take 0.2 us, so the cost is device operations
// and round trips to memory. The earlier kernel here ran about ten: a mask
// chain, a stable multi-kernel radix sort of the slots, a CSR pass and a
// sum in which each (slot, k) thread read whole D-float rows through the
// sort's permutation. Here the slots are already dense in [0, m), so
// positions are grouped with no sort, as dedup_adagrad.cu groups rows, in
// three device operations:
//  1. cudaMemsetAsync clears head[m];
//  2. gpg_insert_kernel, a thread a position, drops not-kept positions and
//     slots outside [0, m) (on the real path the not-kept ones all name
//     slot m - 1) and links each kept one into its slot's list:
//     next[i] = atomicExch(&head[idx[i]], i + 1);
//  3. gpg_sum_kernel, a group of L lanes a slot, each lane PER of its d
//     outputs (k = lane, lane + L, ...; ops.gather_project_grad_plan: the
//     most lanes, up to a lane an output, that keep every slot's lanes
//     resident at once, so one lane a slot at bulk):
//     proj is staged transposed in shared memory, [D][d | 1] (rows padded
//     to an odd stride, so the coalesced copy in stores without bank
//     conflicts), so the lanes of a group read consecutive banks and
//     groups read the same words. An empty slot writes zeros. A slot's
//     first list entry is folded at once, its next link loaded beside its
//     rows, so a slot of one position (7 of 8 kept slots on the path)
//     costs two round trips. A longer list is walked by lane 0 into
//     shared memory (at most kList = min(32 L, 128) positions) and
//     insertion-sorted ascending; a list past kList is found by scanning
//     idx and kept in ascending order, 32 L positions a step (their loads
//     16 L at a time, then a ballot for each L that holds a hit), each
//     step's hits staged in the same shared memory in order. A
//     position's g_wide row is read by every lane of its group (one
//     address: one transaction), CW floats a load (4, 2 or 1, as D and
//     the row's alignment allow), eight loads in flight at a time.
// Per position the fold is the earlier kernel's: fold = fmaf over c = 0..D-1
// ascending from +0.0f against proj row k; then acc += fold + g_narrow[p, k]
// with acc from +0.0f, over a slot's positions in ascending order (the
// stable sort's). The atomics only decide where a position lands, never an
// order of summation, so the result repeats bit for bit and equals the
// earlier kernel's; an empty slot is exactly +0.0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInsertThreads = 256;
constexpr int kWords = 32;  // ballots a step of the scan of a long list
constexpr int kBatch = 8;   // row loads of a position in flight at a time
constexpr int kSmemFloats = 12288;  // proj's limit, as the wrapper checks

__global__ void gpg_insert_kernel(const int32_t* __restrict__ idx, const bool* __restrict__ kept,
                                  int32_t* __restrict__ head, int32_t* __restrict__ next,
                                  int32_t n, int32_t m) {
  const int32_t i = blockIdx.x * kInsertThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t j = idx[i];
  if (!kept[i] || j < 0 || j >= m) return;
  next[i] = atomicExch(&head[j], i + 1);
}

template <int CW>
struct Vec;
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <>
struct Vec<2> {
  float v[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
};
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
};

// L lanes a slot, PER outputs a lane (d <= L * PER), CW floats a row load;
// shared memory: proj [D][d | 1], then kWords * L positions a group
template <int L, int PER, int CW>
__global__ void __launch_bounds__(256) gpg_sum_kernel(
    const float* __restrict__ g_wide, const float* __restrict__ g_narrow,
    const float* __restrict__ proj, const int32_t* __restrict__ idx,
    const bool* __restrict__ kept, const int32_t* __restrict__ head,
    const int32_t* __restrict__ next, float* __restrict__ out, int32_t n, int32_t m, int nd,
    int d) {
  constexpr int kStep = kWords * L;  // positions a scan step
  // positions of a list sorted in the group's kStep of shared memory
  constexpr int kList = kStep < 128 ? kStep : 128;
  extern __shared__ float smem[];
  const int ndp = nd | 1;
  float* s_projT = smem;
  const int grp = threadIdx.x / L, lane = threadIdx.x % L;
  int* buf = reinterpret_cast<int*>(smem + ndp * d) + grp * kStep;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (blockDim.x / L) + grp;
  const int h = j < m ? head[j] : 0;
  for (int e = threadIdx.x; e < nd * d; e += blockDim.x) {
    const int k = e / d;
    s_projT[(e - k * d) * ndp + k] = proj[e];
  }
  __syncthreads();
  if (j >= m) return;  // the whole group leaves together
  int kk[PER];  // this lane's outputs (clamped for the proj read)
#pragma unroll
  for (int t = 0; t < PER; ++t) kk[t] = min(lane + L * t, nd - 1);
  // tv = fold + g_narrow[p] of position p for this lane's outputs
  auto contribution = [&](int p, float (&tv)[PER]) {
    const float* gw = g_wide + static_cast<int64_t>(p) * d;
    const float* gn = g_narrow + static_cast<int64_t>(p) * nd;
    float fold[PER], narrow[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      fold[t] = 0.0f;
      narrow[t] = gn[kk[t]];
    }
    for (int c0 = 0; c0 < d; c0 += kBatch * CW) {
      Vec<CW> x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (c0 + u * CW < d) x[u].load(gw + c0 + u * CW);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u * CW >= d) break;
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          const float* pc = s_projT + (c0 + u * CW + w) * ndp;
#pragma unroll
          for (int t = 0; t < PER; ++t) fold[t] = fmaf(x[u].v[w], pc[kk[t]], fold[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < PER; ++t) tv[t] = fold[t] + narrow[t];
  };
  float acc[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) acc[t] = 0.0f;
  if (h != 0) {
    const int p0 = h - 1;
    const int after = next[p0];
    float t0[PER];
    contribution(p0, t0);  // the list's first entry, its rows beside the link
    if (after == 0) {      // the slot's only position
#pragma unroll
      for (int t = 0; t < PER; ++t) acc[t] += t0[t];
    } else {
      const unsigned gmask = (0xffffffffu >> (32 - L)) << (threadIdx.x & 31 & ~(L - 1));
      int cnt = 0;
      if (lane == 0) {  // walk the list, then insertion-sort it ascending
        buf[0] = p0;
        cnt = 1;
        for (int p = after; p != 0 && cnt <= kList; p = next[p - 1]) {
          if (cnt < kList) buf[cnt] = p - 1;
          ++cnt;
        }
        for (int a = 1; a < cnt && a < kList; ++a) {
          const int v = buf[a];
          int b = a - 1;
          for (; b >= 0 && buf[b] > v; --b) buf[b + 1] = buf[b];
          buf[b + 1] = v;
        }
      }
      cnt = __shfl_sync(gmask, cnt, 0, L);
      __syncwarp(gmask);
      // the sorted list in one round, or a list past kList a scan step a
      // round, its positions staged in ascending order
      const int32_t slot = static_cast<int32_t>(j);
      const unsigned base = threadIdx.x & 31 & ~(L - 1);
      for (int64_t q0 = 0;; q0 += kStep) {
        int staged = cnt;
        if (cnt > kList) {
          unsigned mine = 0;  // bit u: position q0 + u * L + lane is the slot's
#pragma unroll 16
          for (int u = 0; u < kWords; ++u) {
            const int64_t q = q0 + u * L + lane;
            const bool in = q < n;
            const bool k = in ? kept[q] : false;
            const int32_t r = in ? idx[q] : -1;
            mine |= static_cast<unsigned>(k & (r == slot)) << u;
          }
          __syncwarp(gmask);  // the previous step's positions are all read
          staged = 0;
          unsigned words = mine;  // the words with a hit in any lane, in order
          for (int o = L / 2; o > 0; o >>= 1) words |= __shfl_xor_sync(gmask, words, o, L);
          for (; words; words &= words - 1) {
            const int u = __ffs(words) - 1;
            unsigned bits = __ballot_sync(gmask, (mine >> u) & 1u) >> base;
            if constexpr (L < 32) bits &= (1u << L) - 1;
            if (lane == 0)
              for (unsigned b = bits, o = staged; b; b &= b - 1, ++o)
                buf[o] = static_cast<int>(q0 + u * L + __ffs(b) - 1);
            staged += __popc(bits);
          }
          __syncwarp(gmask);
        }
        for (int a = 0; a < staged; ++a) {
          const int p = buf[a];
          float tv[PER];
          if (p == p0) {
#pragma unroll
            for (int t = 0; t < PER; ++t) tv[t] = t0[t];
          } else {
            contribution(p, tv);
          }
#pragma unroll
          for (int t = 0; t < PER; ++t) acc[t] += tv[t];
        }
        if (cnt <= kList || q0 + kStep >= n) break;
      }
    }
  }
  float* o = out + j * nd;
#pragma unroll
  for (int t = 0; t < PER; ++t)
    if (lane + L * t < nd) o[lane + L * t] = acc[t];
}

struct Args {
  const float *gw, *gn, *proj;
  const int32_t* idx;
  const bool* kept;
  const int32_t *head, *next;
  float* out;
  int32_t n, m;
  int nd, d, threads;
};

template <int L, int PER, int CW>
int launch_sum(const Args& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * (a.nd | 1) * a.d + sizeof(int) * kWords * a.threads;
  auto kernel = gpg_sum_kernel<L, PER, CW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = a.threads / L;
  kernel<<<static_cast<unsigned int>((static_cast<int64_t>(a.m) + groups - 1) / groups),
           a.threads, smem, st>>>(a.gw, a.gn, a.proj, a.idx, a.kept, a.head, a.next, a.out,
                                  a.n, a.m, a.nd, a.d);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int PER>
int launch_cw(int cw, const Args& a, cudaStream_t st) {
  if (cw == 4) return launch_sum<L, PER, 4>(a, st);
  if (cw == 2) return launch_sum<L, PER, 2>(a, st);
  return launch_sum<L, PER, 1>(a, st);
}

template <int L>
int launch_per(int per, int cw, const Args& a, cudaStream_t st) {
  if (per == 1) return launch_cw<L, 1>(cw, a, st);
  if (per == 2) return launch_cw<L, 2>(cw, a, st);
  if (per == 4) return launch_cw<L, 4>(cw, a, st);
  return launch_cw<L, 8>(cw, a, st);
}

}  // namespace

// g_wide [n, D], g_narrow [n, d], proj [d, D] (float32), idx [n] int32,
// kept [n] bool; `scratch` holds m + n int32 (head, then next); out [m, d].
// `lanes`, `cw` and `threads` from ops.gather_project_grad_plan: lanes a
// slot (1 to 32, a power of two, at least d / 8: each lane takes
// ceil(d / lanes) outputs, rounded up to a power of two), floats a g_wide
// load (D and g_wide's alignment allow it), threads a block (32 to 256, a
// multiple of 32; over 48 KB of shared memory the sum kernel opts in).
// Needs 0 < m, 0 <= n, n and m < 2^31 - 1, 0 < d <= 256 and d * D <= 12,288
// (the wrapper checks). One memset and two kernels on `stream` (the insert
// is skipped for n = 0); returns the first CUDA error so the caller can
// raise.
extern "C" int gather_project_grad_launch(const void* g_wide, const void* g_narrow,
                                          const void* proj, const void* idx, const void* kept,
                                          void* scratch, void* out, int64_t n, int64_t m,
                                          int nd, int d, int lanes, int cw, int threads,
                                          void* stream) {
  const int64_t limit = (int64_t{1} << 31) - 1;
  const bool lanes_ok = lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (m <= 0 || n < 0 || n >= limit || m >= limit || nd <= 0 || nd > 256 || d <= 0 ||
      static_cast<int64_t>(nd) * d > kSmemFloats || !lanes_ok || nd > 8 * lanes ||
      (cw != 1 && cw != 2 && cw != 4) || d % cw != 0 ||
      reinterpret_cast<uintptr_t>(g_wide) % (4 * cw) != 0 || threads < 32 || threads > 256 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* head = static_cast<int32_t*>(scratch);
  int32_t* next = head + m;
  cudaError_t err = cudaMemsetAsync(head, 0, static_cast<size_t>(m) * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* ip = static_cast<const int32_t*>(idx);
  const auto* kp = static_cast<const bool*>(kept);
  const int32_t n32 = static_cast<int32_t>(n), m32 = static_cast<int32_t>(m);
  if (n > 0) {
    gpg_insert_kernel<<<static_cast<unsigned int>((n + kInsertThreads - 1) / kInsertThreads),
                        kInsertThreads, 0, st>>>(ip, kp, head, next, n32, m32);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{static_cast<const float*>(g_wide), static_cast<const float*>(g_narrow),
               static_cast<const float*>(proj), ip, kp, head, next, static_cast<float*>(out),
               n32, m32, nd, d, threads};
  int per = 1;
  while (per * lanes < nd) per *= 2;
  switch (lanes) {
    case 1: return launch_per<1>(per, cw, a, st);
    case 2: return launch_per<2>(per, cw, a, st);
    case 4: return launch_per<4>(per, cw, a, st);
    case 8: return launch_per<8>(per, cw, a, st);
    case 16: return launch_per<16>(per, cw, a, st);
    default: return launch_per<32>(per, cw, a, st);
  }
}
