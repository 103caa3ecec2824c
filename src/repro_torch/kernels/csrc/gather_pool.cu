// Fused gather + pool (forward SegmentReduction) over the unique rows.
//
// Replaces gather_pool_pallas (src/repro/kernels/fused_embedding.py:81) and
// embedding_bag_pallas (src/repro/kernels/embedding_bag.py:41) beneath it:
//   bags[seg[i]] += w[i] * rows_u[inv[i]],  seg sorted ascending,
// positions whose seg lies outside [0, n_bags) dropped, and a bag no
// position maps to exactly 0.
//
// Bound: bytes. Per position it reads inv, w, seg and one D-float row, and
// per bag it writes D floats; two flops per element. The TPU kernel walks
// positions on a sequential grid and keeps one bag block in VMEM while its
// segment lasts, with one zero-weight ghost position per bag merged in (an
// extra argsort) so that an uncovered bag is written at all. Hopper blocks
// run in parallel and in no order, and at the paths' shapes (10-20 K
// positions, one a bag) a call is a few dependent round trips to device
// memory, so the kernel is one launch with two of them and no scratch:
//  - a block takes a tile of positions and stages their seg, inv and w in
//    shared memory with coalesced loads, one load per position, together
//    with the seg just before and just after the tile;
//  - a group of lanes sized to the row (float4 lanes at D = 16 and 128,
//    float2 at D = 10; a warp, looping over column chunks, past 32 vectors)
//    owns four consecutive positions of the tile (fewer were no faster at
//    any path shape on the H100). A bag starts where
//    seg[i - 1] != seg[i]; the group that holds a bag's first position sums
//    all of that bag's positions, reading past its positions, and past the
//    tile, while the run lasts. The row loads of a batch of up to four
//    positions are all issued before the adds;
//  - the owner of a bag's first position i also writes the exact zeros of
//    the uncovered bags in (seg[i - 1], seg[i]); every block zeroes a
//    share of the bags after seg[n - 1].
// Every bag sums its positions in ascending order from +0.0f, each product
// rounded on its own (__fmul_rn, no contraction), as the reference's
// multiply-then-sum: no atomics, the result repeats bit for bit, and it is
// bit for bit the two-pass (CSR offsets, then pool) kernel this replaced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerGroup = 4;  // positions a group owns, and rows it loads at once

template <int W>
struct alignas(4 * W) Frag {
  float v[W];
};

// The lane groups of a block: `lanes` vectors of W floats a row, groups of
// min(lanes, 32) lanes, 32 / that many a warp, each owning kPerGroup
// consecutive positions of the block's tile.
struct Groups {
  int lanes, size, per_warp, tile;
  __host__ __device__ Groups(int d, int w)
      : lanes(d / w), size(d / w < 32 ? d / w : 32), per_warp(32 / size),
        tile(kThreads / 32 * per_warp * kPerGroup) {}
};

template <int W>
__global__ void __launch_bounds__(kThreads) gather_pool_kernel(
    const float* __restrict__ rows, const int32_t* __restrict__ inv,
    const float* __restrict__ w, const int32_t* __restrict__ seg, float* __restrict__ out,
    int32_t n, int32_t n_bags, int d) {
  extern __shared__ int32_t sm[];
  const Groups G(d, W);
  // positions t0 - 1 .. t0 + cnt: seg [cnt + 2], then inv and w [cnt]
  int32_t* s_seg = sm;
  int32_t* s_inv = sm + G.tile + 2;
  float* s_w = reinterpret_cast<float*>(s_inv + G.tile);
  const int tid = threadIdx.x;
  const int32_t last = n > 0 ? seg[n - 1] : -1;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * G.tile;

  if (t0 < n) {  // uniform over the block
    const int cnt = static_cast<int>(n - t0 < G.tile ? n - t0 : G.tile);
    for (int e = tid; e < cnt + 2; e += kThreads) {
      const int64_t q = t0 + e - 1;
      s_seg[e] = q < 0 ? -1 : q < n ? seg[q] : 0;  // the entry past n is never read
    }
    for (int e = tid; e < cnt; e += kThreads) {
      s_inv[e] = inv[t0 + e];
      s_w[e] = w[t0 + e];
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    const int gw = lane / G.size, gl = lane - gw * G.size;
    const int a = (warp * G.per_warp + gw) * kPerGroup;  // in the tile
    const int stop = a + kPerGroup < cnt ? a + kPerGroup : cnt;
    if (gw < G.per_warp && a < stop) {
      // s_seg[i + 1] is the seg of tile position i (i = -1 .. cnt)
      const int32_t before = s_seg[a];
      int first = a;  // positions of a run that began before a are not this group's
      while (first < stop && s_seg[first + 1] == before) ++first;
      // the run at stop - 1, which this group owns if it has a start; where
      // it goes on past stop, the walk reads on, past the tile too
      const int32_t end_seg = s_seg[stop];
      const bool goes_on = t0 + stop < n && s_seg[stop + 1] == end_seg;
      for (int c0 = 0; first < stop && c0 < G.lanes; c0 += G.size) {
        const int v = c0 + gl;  // this lane's vector of the row
        const bool col = v < G.lanes;
        int32_t cur = before;
        bool owned = false;
        Frag<W> acc = {};
        // adds positions 0 .. cnt_b - 1 of a batch, their rows loaded first
        auto consume = [&](int cnt_b, const int32_t* sb, const int32_t* ib, const float* wb) {
          Frag<W> r[kPerGroup];
#pragma unroll
          for (int u = 0; u < kPerGroup; ++u)
            if (u < cnt_b && col && sb[u] >= 0 && sb[u] < n_bags)
              r[u] = *reinterpret_cast<const Frag<W>*>(
                  rows + static_cast<int64_t>(ib[u]) * d + v * W);
#pragma unroll
          for (int u = 0; u < kPerGroup; ++u) {
            if (u >= cnt_b) continue;
            if (sb[u] != cur) {  // a bag starts here
              if (owned && col)
                *reinterpret_cast<Frag<W>*>(out + static_cast<int64_t>(cur) * d + v * W) = acc;
              const int32_t hi = sb[u] < n_bags ? sb[u] : n_bags;
              if (col)
                for (int64_t z = cur < 0 ? 0 : static_cast<int64_t>(cur) + 1; z < hi; ++z)
                  *reinterpret_cast<Frag<W>*>(out + z * d + v * W) = Frag<W>{};
              cur = sb[u];
              owned = cur >= 0 && cur < n_bags;
              acc = Frag<W>{};
            }
            if (owned && col) {
#pragma unroll
              for (int k = 0; k < W; ++k) acc.v[k] = acc.v[k] + __fmul_rn(wb[u], r[u].v[k]);
            }
          }
        };
        int32_t sb[kPerGroup], ib[kPerGroup];
        float wb[kPerGroup];
        // 1. the group's own positions, from shared memory
#pragma unroll
        for (int u = 0; u < kPerGroup; ++u) {
          if (first + u < stop) {
            sb[u] = s_seg[first + u + 1];
            ib[u] = s_inv[first + u];
            wb[u] = s_w[first + u];
          }
        }
        consume(stop - first, sb, ib, wb);
        // 2. the rest of the run at stop - 1: batches of independent loads,
        //    whose positions of the run are a prefix (seg is sorted)
        for (int64_t q = t0 + stop; goes_on && q < n;) {
#pragma unroll
          for (int u = 0; u < kPerGroup; ++u) {
            const int64_t qq = q + u;
            const int64_t i = qq - t0;
            if (qq < n) {
              sb[u] = i <= cnt ? s_seg[i + 1] : seg[qq];
              ib[u] = i < cnt ? s_inv[i] : inv[qq];
              wb[u] = i < cnt ? s_w[i] : w[qq];
            }
          }
          int cnt_b = 0;
#pragma unroll
          for (int u = 0; u < kPerGroup; ++u) cnt_b += cnt_b == u && q + u < n && sb[u] == end_seg;
          consume(cnt_b, sb, ib, wb);
          q = cnt_b < kPerGroup ? n : q + kPerGroup;  // a short batch ends the run
        }
        if (owned && col)
          *reinterpret_cast<Frag<W>*>(out + static_cast<int64_t>(cur) * d + v * W) = acc;
      }
    }
  }

  // the bags after the last position's, which no start zeroes
  const int64_t lo = (last < 0 ? 0 : static_cast<int64_t>(last) + 1) * d;
  const int64_t hi = static_cast<int64_t>(n_bags) * d;
  for (int64_t i = lo + static_cast<int64_t>(blockIdx.x) * kThreads + tid; i < hi;
       i += static_cast<int64_t>(gridDim.x) * kThreads)
    out[i] = 0.0f;
}

template <int W>
int launch(const float* rows, const int32_t* inv, const float* w, const int32_t* seg,
           float* out, int64_t n, int64_t n_bags, int d, cudaStream_t s) {
  const Groups G(d, W);
  const int64_t tiles = (n + G.tile - 1) / G.tile;
  // bags beyond the positions' count can only be zeroed: a block per 8 K floats
  const int64_t spare = n_bags > n ? ((n_bags - n) * d + 8191) / 8192 : 0;
  int64_t grid = tiles > spare ? tiles : spare;
  if (grid < 1) grid = 1;
  const size_t smem = static_cast<size_t>(3 * G.tile + 2) * sizeof(int32_t);
  gather_pool_kernel<W><<<static_cast<unsigned int>(grid), kThreads, smem, s>>>(
      rows, inv, w, seg, out, static_cast<int32_t>(n), static_cast<int32_t>(n_bags), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, one kernel and no scratch. Needs n, n_bags < 2^31
// and 0 < d (the wrapper checks). Rows are read and bags written as float4
// where D and both pointers allow it, else float2, else float. Returns
// cudaGetLastError() so the caller can raise.
extern "C" int gather_pool_launch(const void* rows_u, const void* inv, const void* w,
                                  const void* seg, void* out, int64_t n, int64_t n_bags,
                                  int d, void* stream) {
  if (n < 0 || n_bags < 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(rows_u) | reinterpret_cast<uintptr_t>(out);
  const float* r = static_cast<const float*>(rows_u);
  const int32_t* iv = static_cast<const int32_t*>(inv);
  const float* wp = static_cast<const float*>(w);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && align % 16 == 0) return launch<4>(r, iv, wp, sg, o, n, n_bags, d, s);
  if (d % 2 == 0 && align % 8 == 0) return launch<2>(r, iv, wp, sg, o, n, n_bags, d, s);
  return launch<1>(r, iv, wp, sg, o, n, n_bags, d, s);
}
