// Dedup + row-wise Adagrad, in place on the table and its accumulator.
//
// Replaces dedup_adagrad_pallas (src/repro/kernels/fused_embedding.py:194).
// For every distinct kept destination row r of the m gradient rows (kept:
// valid and 0 <= idx < rows):
//   gsum = sum_{idx[j] = r} g[j]          (in ascending position order, from +0.0f)
//   acc[r] += mean_d(gsum^2);  w[r] -= lr * gsum / sqrt(acc[r] + eps)
//
// Bound: bytes. It reads idx, valid and the m D-float gradient rows once,
// and reads and writes each touched row of w and acc once; a handful of
// flops per element, a few microseconds of bytes on the training path. The
// TPU kernel walks argsort-ed positions on a sequential grid after its
// wrapper has gathered the gradient rows into sorted order. A device-wide
// sort here costs several kernels for a job whose bytes take half a
// microsecond, and it orders nothing on the paths that call this: their
// kept indices are distinct (unique ids), or repeat at most once per
// source rank. So positions are grouped by hashing instead, in three
// device operations and no sort:
//  1. cudaMemsetAsync clears a table of `cap` slots (a power of two >= 2m,
//     so linear probing always finds a free slot), each {row + 1, head}.
//  2. dedup_group_kernel, a thread a position: the mask is fused (dropped
//     positions get slot_of = -1); a kept position inserts its row by
//     linear probing from a multiplicative hash with atomicCAS, and links
//     itself into its slot's list with next[j] = atomicExch(head, j + 1).
//     The position whose atomicCAS filled the slot owns the row: slot_of[j]
//     is its slot, every other position's is -1.
//  3. dedup_update_kernel, a group of L lanes a position (L = 16 for
//     D <= 16, else a warp): only owners act. A row with one position
//     (its list is just the owner) sums +0.0f + g[j]: the common case, and
//     every case at world 1. Its loads (list head, link, gradient row, and
//     the row of w and acc, at idx[j] again rather than at the slot's key)
//     are all issued before the first is used, so a position costs two
//     dependent trips to memory. Otherwise the group's first lane walks the
//     list (at most 32 positions) into shared memory and sorts it
//     ascending, and the lanes sum the rows in that order, four rows'
//     loads in flight at a time; a row with more than 32 positions is
//     found by scanning idx in ascending order, 128 positions a step by
//     ballots, each step's hits staged and summed the same way. The owner
//     then reduces mean(gsum^2) by a shuffle butterfly, and updates its
//     row of w and acc in place.
// The atomics only decide where a position lands, never an order of
// summation, so the result repeats bit for bit and equals the sort-based
// kernel's: the same ascending sums, the same round-to-nearest intrinsics
// (no FMA contraction reorders the reference's multiply, divide and sqrt),
// and for L = 16 the same butterfly, whose first step over 32 lanes only
// adds the exact zeros of lanes 16-31. Rows no kept position names are
// never read or written, so they stay bitwise unchanged.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kList = 32;  // positions of a row's list it sorts in shared memory
constexpr int kBuf = 128;  // positions a group stages in shared memory
constexpr unsigned kGolden = 2654435769u;  // 2^32 / phi: Fibonacci hashing

__global__ void dedup_group_kernel(const int32_t* __restrict__ idx,
                                   const bool* __restrict__ valid, int2* __restrict__ tab,
                                   int32_t* __restrict__ next, int32_t* __restrict__ slot_of,
                                   int64_t m, int64_t rows, unsigned shift, unsigned mask) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int32_t row = idx[j];
  if (!valid[j] || row < 0 || row >= rows) {
    slot_of[j] = -1;
    return;
  }
  const int want = row + 1;  // 0 marks a free slot
  unsigned s = (static_cast<unsigned>(row) * kGolden) >> shift;
  bool owner;
  for (;;) {
    const int prev = atomicCAS(&tab[s].x, 0, want);
    if (prev == 0 || prev == want) {
      owner = prev == 0;
      break;
    }
    s = (s + 1) & mask;
  }
  next[j] = atomicExch(&tab[s].y, static_cast<int>(j) + 1);
  slot_of[j] = owner ? static_cast<int>(s) : -1;
}

template <int L>
__global__ void __launch_bounds__(kThreads) dedup_update_kernel(
    float* __restrict__ w, float* __restrict__ acc, const int32_t* __restrict__ idx,
    const bool* __restrict__ valid, const float* __restrict__ g,
    const int2* __restrict__ tab, const int32_t* __restrict__ next,
    const int32_t* __restrict__ slot_of, int64_t m, int d, float lr, float eps) {
  constexpr int kPer = L == 32 ? 4 : 1;  // D <= L * kPer
  constexpr int kWords = kBuf / L;       // ballots a scan step
  __shared__ int buf[kThreads / L][kBuf];
  const int grp = threadIdx.x / L, lane = threadIdx.x % L;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * (kThreads / L) + grp;
  if (j >= m) return;  // the whole group leaves together
  const int s = slot_of[j];
  const int row = idx[j];  // the owner's own row: it filled the slot
  if (s < 0) return;       // dropped, or not the row's owner
  // every load the common case needs, issued together: the slot's list
  // head, this position's link and gradient, and the row's state
  const int head = tab[s].y, after = next[j];
  float* wr = w + static_cast<int64_t>(row) * d;
  const float acc_old = acc[row];
  float w_old[kPer], g_own[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool in = lane + L * k < d;
    w_old[k] = in ? wr[lane + L * k] : 0.0f;
    g_own[k] = in ? g[j * d + lane + L * k] : 0.0f;
  }
  const unsigned gmask = L == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  float gs[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) gs[k] = 0.0f;
  // gs += g[pos] for the n positions staged in buf, in their order; the
  // rows of four positions are loaded before the first of their adds
  auto add_staged = [&](int n) {
    const int* staged = buf[grp];
    for (int t = 0; t < n; t += 4) {
      float v[4][kPer];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* gp = g + static_cast<int64_t>(staged[t + i < n ? t + i : t]) * d;
#pragma unroll
        for (int k = 0; k < kPer; ++k) v[i][k] = lane + L * k < d ? gp[lane + L * k] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (t + i < n && lane + L * k < d) gs[k] += v[i][k];
    }
  };
  if (head == j + 1 && after == 0) {  // the row's only position
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (lane + L * k < d) gs[k] += g_own[k];
  } else {
    int n = 0;
    if (lane == 0) {  // walk the list, then insertion-sort it ascending
      int* mine = buf[grp];
      for (int p = head; p != 0 && n <= kList; p = next[p - 1]) {
        if (n < kList) mine[n] = p - 1;
        ++n;
      }
      for (int a = 1; a < n && a < kList; ++a) {
        const int v = mine[a];
        int b = a - 1;
        for (; b >= 0 && mine[b] > v; --b) mine[b + 1] = mine[b];
        mine[b + 1] = v;
      }
    }
    n = __shfl_sync(gmask, n, 0, L);
    __syncwarp(gmask);
    if (n <= kList) {
      add_staged(n);
    } else {  // a long run: its positions in ascending order by a scan of idx
      const unsigned base_lane = threadIdx.x & 31 & ~(L - 1);
      for (int64_t q0 = 0; q0 < m; q0 += kBuf) {
        bool hit[kWords];
#pragma unroll
        for (int u = 0; u < kWords; ++u) {  // all loads issued before a ballot
          const int64_t q = q0 + u * L + lane;
          const bool in = q < m;
          const bool v = in ? valid[q] : false;
          const int32_t r = in ? idx[q] : -1;
          hit[u] = v & (r == row);
        }
        unsigned bits[kWords];
        int n_hit = 0;
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          bits[u] = __ballot_sync(gmask, hit[u]) >> base_lane;
          if constexpr (L < 32) bits[u] &= (1u << L) - 1;
          n_hit += __popc(bits[u]);
        }
        __syncwarp(gmask);  // the previous step's positions are all read
        if (lane == 0) {
          int at = 0;
#pragma unroll
          for (int u = 0; u < kWords; ++u)
            for (unsigned b = bits[u]; b; b &= b - 1)
              buf[grp][at++] = static_cast<int>(q0 + u * L + __ffs(b) - 1);
        }
        __syncwarp(gmask);
        add_staged(n_hit);
      }
    }
  }
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = lane + L * k;
    if (c < d) sq += __fmul_rn(gs[k], gs[k]);
  }
  for (int off = L / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(gmask, sq, off, L);
  const float a = __fadd_rn(acc_old, __fdiv_rn(sq, static_cast<float>(d)));
  const float denom = __fsqrt_rn(__fadd_rn(a, eps));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = lane + L * k;
    if (c < d) wr[c] = __fsub_rn(w_old[k], __fdiv_rn(__fmul_rn(lr, gs[k]), denom));
  }
  if (lane == 0) acc[row] = a;
}

}  // namespace

// `idx` [m] int32 destination rows, `valid` [m] bool, `g` [m, d]; `scratch`
// holds `scratch_ints` int32s: the table (2 * cap), then next and slot_of
// (m each), with cap a power of two >= 2m (the wrapper's ops.dedup_scratch).
// Updates w [rows, d] and acc [rows, 1] in place on `stream`: one memset
// and two kernels. Needs 0 < d <= 128, rows < 2^31 - 1 and m < 2^30 (the
// wrapper checks). Returns the first CUDA error so the caller can raise.
extern "C" int dedup_adagrad_launch(void* w, void* acc, const void* idx, const void* valid,
                                    const void* g, void* scratch, int64_t scratch_ints,
                                    int64_t m, int64_t rows, int d, int64_t cap, float lr,
                                    float eps, void* stream) {
  if (m <= 0 || d <= 0 || d > 128 || cap < 2 * m || cap > (int64_t{1} << 31) ||
      (cap & (cap - 1)) != 0 || scratch_ints < 2 * cap + 2 * m)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* tab = static_cast<int2*>(scratch);
  int32_t* next = static_cast<int32_t*>(scratch) + 2 * cap;
  int32_t* slot_of = next + m;
  cudaError_t err = cudaMemsetAsync(tab, 0, static_cast<size_t>(cap) * sizeof(int2), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned log2cap = static_cast<unsigned>(__builtin_ctzll(static_cast<uint64_t>(cap)));
  const auto* ip = static_cast<const int32_t*>(idx);
  const auto* vp = static_cast<const bool*>(valid);
  dedup_group_kernel<<<static_cast<unsigned int>((m + kThreads - 1) / kThreads), kThreads, 0,
                       st>>>(ip, vp, tab, next, slot_of, m, rows, 32u - log2cap,
                             static_cast<unsigned>(cap - 1));
  const auto* gp = static_cast<const float*>(g);
  auto* wp = static_cast<float*>(w);
  auto* ap = static_cast<float*>(acc);
  if (d <= 16) {
    constexpr int per = kThreads / 16;
    dedup_update_kernel<16><<<static_cast<unsigned int>((m + per - 1) / per), kThreads, 0, st>>>(
        wp, ap, ip, vp, gp, tab, next, slot_of, m, d, lr, eps);
  } else {
    constexpr int per = kThreads / 32;
    dedup_update_kernel<32><<<static_cast<unsigned int>((m + per - 1) / per), kThreads, 0, st>>>(
        wp, ap, ip, vp, gp, tab, next, slot_of, m, d, lr, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
