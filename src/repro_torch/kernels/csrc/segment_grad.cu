// Segment-grad: the transpose of gather_pool onto the unique-row slots,
//   g_rows[u] = sum_{inv[i] = u} w[i] * g_bags[seg[i]],  for u < n_rows.
//
// Replaces segment_grad_pallas (src/repro/kernels/fused_embedding.py:111),
// which reaches pallas_call through embedding_bag_pallas
// (src/repro/kernels/embedding_bag.py:60).
//
// Bound: bytes. Per position the function reads seg, w, its slot (inv) and
// one D-float bag gradient; per slot it writes D floats; two flops per
// element. The kernel also reads the sort's int64 order, 8 bytes a position
// the bound does not count. In practice latency: a training step has about
// 10,000 positions, and a slot's sum is a chain of dependent additions.
//
// The caller passes `order`, a stable argsort of the positions by slot, and
// `sorted_inv`, the slots in that order (the forward's unique already has
// both), so each slot's positions are one contiguous range of the sorted
// order. One launch, no atomics on the output:
//   - block b owns the slots whose range starts in its tile of `tile`
//     sorted positions. It stages in shared memory, three round trips in
//     all: the slots and order of the tile and of up to 256 positions past
//     it; then seg and w through the order, for the positions up to the end
//     of the tile's last run only (read off the staged slots); then every
//     product w * g_bags[seg] (__fmul_rn, never contracted into an FMA).
//     The gathers of a round trip are all in flight at once, and no step of
//     a slot's sum waits on device memory;
//   - one thread per (slot, column) adds its range's products in ascending
//     sorted position, which is ascending original position (the sort is
//     stable): the reference segment_sum's order, so the output is bitwise
//     that of the earlier CSR + pool kernels;
//   - a run longer than the lookahead (a hot row's run reaches 200
//     positions at B = 256) goes on in chunks of `chunk` positions, staged
//     the same way, which threads 0..D-1 keep adding to the same registers;
//   - slots that no position maps to come out exactly 0: the run that ends
//     a gap zeroes it, and every block zeroes a share of the tail after the
//     last slot (n - n_uniq rows on the training path).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 1024 / kThreads;  // columns a walker thread carries
constexpr int kBatch = 4;                  // index loads a thread issues at once
constexpr int kRowBatch = 8;               // bag-gradient loads a thread issues at once
constexpr int kLook = 256;                 // positions staged past the tile, at most

// A block's shared memory, in bytes from its start: the products
// (chunk * max(d, 2) floats, overlaying the chunk's int64 order), then the
// weights and bag ids (chunk each), the slots (chunk + 2) and the run
// starts (tile + 1). The kernel carves it and the launcher sizes it here.
struct Layout {
  int w, seg, slot, start, bytes;
};

__host__ __device__ inline Layout layout(int tile, int chunk, int d) {
  Layout l;
  l.w = chunk * (d > 2 ? d : 2) * 4;
  l.seg = l.w + chunk * 4;
  l.slot = l.seg + chunk * 4;
  l.start = l.slot + (chunk + 2) * 4;
  l.bytes = l.start + (tile + 1) * 4;
  return l;
}

// Round trip 1 for positions [c0, c0 + cnt): their order into s_order, and
// the slots of positions c0 - 1 .. c0 + cnt into s_slot[0 .. cnt + 1] (0
// outside [0, n)). Every thread takes part; it ends at a barrier.
__device__ void stage_order(const int64_t* __restrict__ order,
                            const int32_t* __restrict__ sinv, int32_t n, int32_t c0,
                            int cnt, int64_t* s_order, int32_t* s_slot) {
  for (int i = threadIdx.x; i < cnt + 2; i += kThreads) {
    const int32_t q = c0 - 1 + i;
    s_slot[i] = q >= 0 && q < n ? sinv[q] : 0;
    if (i < cnt) s_order[i] = order[c0 + i];
  }
  __syncthreads();
}

// Round trip 2: seg and w of the first cnt staged positions, through the
// order. Ends at a barrier.
__device__ void stage_rows(const int32_t* __restrict__ seg, const float* __restrict__ w,
                           int cnt, const int64_t* s_order, float* s_w, int32_t* s_seg) {
  for (int i0 = threadIdx.x; i0 < cnt; i0 += kThreads * kBatch) {
    int32_t sg[kBatch];
    float wt[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i < cnt) {
        sg[k] = seg[s_order[i]];
        wt[k] = w[s_order[i]];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i < cnt) {
        s_seg[i] = sg[k];
        s_w[i] = wt[k];
      }
    }
  }
  __syncthreads();
}

// Round trip 3: s_prod[i * d + c] = w * g_bags[seg * d + c] for the first
// cnt staged positions, rounded on its own (no FMA contraction), as the
// reference multiplies before it sums. s_prod overlays s_order, which round
// trip 2 has read in full. Ends at a barrier.
template <int V>
__device__ void stage_products(const float* __restrict__ g_bags, int cnt, int d,
                               float* s_prod, const float* s_w, const int32_t* s_seg) {
  const int dv = d / V;
  const int total = cnt * dv;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kRowBatch) {
    if constexpr (V == 4) {
      float4 g[kRowBatch];
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int e = e0 + k * kThreads;
        if (e < total) {
          const int i = e / dv, c = e - i * dv;
          g[k] = reinterpret_cast<const float4*>(
              g_bags + static_cast<int64_t>(s_seg[i]) * d)[c];
        }
      }
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int e = e0 + k * kThreads;
        if (e < total) {
          const int i = e / dv, c = e - i * dv;
          const float wi = s_w[i];
          reinterpret_cast<float4*>(s_prod + i * d)[c] =
              make_float4(__fmul_rn(wi, g[k].x), __fmul_rn(wi, g[k].y),
                          __fmul_rn(wi, g[k].z), __fmul_rn(wi, g[k].w));
        }
      }
    } else {
      float g[kRowBatch];
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int e = e0 + k * kThreads;
        if (e < total) {
          const int i = e / d;
          g[k] = g_bags[static_cast<int64_t>(s_seg[i]) * d + (e - i * d)];
        }
      }
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const int e = e0 + k * kThreads;
        if (e < total) s_prod[e] = __fmul_rn(s_w[e / d], g[k]);
      }
    }
  }
  __syncthreads();
}

// Column c of slot s, whose run follows slot `prev` (-1 before the first):
// the gap rows between them are zeroed, then the sum is written. Slots
// outside [0, n_rows) are not written.
__device__ __forceinline__ void write_run(float* __restrict__ out, int32_t prev, int32_t s,
                                          float acc, int c, int d, int64_t n_rows) {
  const int64_t gap_end = s < n_rows ? s : n_rows;
  for (int64_t g = prev + 1 > 0 ? prev + 1 : 0; g < gap_end; ++g) out[g * d + c] = 0.0f;
  if (s >= 0 && s < n_rows) out[static_cast<int64_t>(s) * d + c] = acc;
}

// acc + s_prod[a * d + c] + ... + s_prod[(b - 1) * d + c], in that order;
// eight shared loads are issued before their additions.
__device__ __forceinline__ float add_run(const float* s_prod, int a, int b, int d, int c,
                                         float acc) {
  int i = a;
  for (; i + 8 <= b; i += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = s_prod[(i + k) * d + c];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += v[k];
  }
  for (; i < b; ++i) acc += s_prod[i * d + c];
  return acc;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
segment_grad_kernel(const float* __restrict__ g_bags, const int32_t* __restrict__ seg,
                    const float* __restrict__ w, const int64_t* __restrict__ order,
                    const int32_t* __restrict__ sinv, float* __restrict__ out,
                    int32_t n, int64_t n_rows, int d, int tile, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(tile, chunk, d);
  float* s_prod = reinterpret_cast<float*>(smem);
  int64_t* s_order = reinterpret_cast<int64_t*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + l.w);
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem + l.seg);
  int32_t* s_slot = reinterpret_cast<int32_t*>(smem + l.slot);
  int32_t* s_start = reinterpret_cast<int32_t*>(smem + l.start);
  __shared__ int s_end, s_count[kThreads / 32], s_last[kThreads / 32];
  const int tid = threadIdx.x;

  // the tail after the last slot, shared out over every block
  const int64_t z0 = n > 0 ? static_cast<int64_t>(sinv[n - 1]) + 1 : 0;
  if (z0 < n_rows) {
    const int64_t from = (z0 > 0 ? z0 : 0) * d, total = n_rows * d - from;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + tid; e < total;
         e += static_cast<int64_t>(gridDim.x) * kThreads)
      out[from + e] = 0.0f;
  }
  const int32_t t0 = blockIdx.x * tile;
  if (t0 >= n) return;
  const int cnt0 = n - t0 < tile ? n - t0 : tile;
  const int span0 = min(n - t0, min(chunk, tile + kLook));

  // 1. slots and order of the tile and its lookahead (s_slot[i] is position
  //    t0 - 1 + i)
  if (tid == 0) s_end = span0;
  stage_order(order, sinv, n, t0, span0, s_order, s_slot);
  // 2. the runs that start in the tile (tile <= kThreads: a position a thread)
  const bool start = tid < cnt0 && (t0 + tid == 0 || s_slot[tid] != s_slot[tid + 1]);
  const unsigned ballot = __ballot_sync(0xffffffffu, start);
  if ((tid & 31) == 0) {
    s_count[tid >> 5] = __popc(ballot);
    s_last[tid >> 5] = ballot ? (tid & ~31) + 31 - __clz(ballot) : -1;
  }
  __syncthreads();
  int rank = __popc(ballot & ((1u << (tid & 31)) - 1u)), runs = 0, last = -1;
  for (int k = 0; k < kThreads / 32; ++k) {
    rank += k < (tid >> 5) ? s_count[k] : 0;
    runs += s_count[k];
    last = max(last, s_last[k]);
  }
  if (runs == 0) return;  // the whole tile lies inside an earlier block's run
  if (start) s_start[rank] = tid;
  if (tid == 0) s_start[runs] = cnt0;
  // 3. where the tile's last run ends within the lookahead
  const int32_t slot_last = s_slot[last + 1];
  const int32_t slot_prev = t0 + last == 0 ? -1 : s_slot[last];
  for (int i = cnt0 + tid; i < span0; i += kThreads)
    if (s_slot[i + 1] != slot_last) atomicMin(&s_end, i);
  __syncthreads();
  const int end0 = s_end;
  bool goes_on = end0 == span0 && t0 + span0 < n && s_slot[span0 + 1] == slot_last;
  // 4. seg, w and the products up to that end, then every run but the
  //    last, (slot, column) a thread, summed in ascending position
  stage_rows(seg, w, end0, s_order, s_w, s_seg);
  stage_products<V>(g_bags, end0, d, s_prod, s_w, s_seg);
  for (int e = tid; e < (runs - 1) * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int a = s_start[r];
    write_run(out, t0 + a == 0 ? -1 : s_slot[a], s_slot[a + 1],
              add_run(s_prod, a, s_start[r + 1], d, c, 0.0f), c, d, n_rows);
  }
  // 5. the last run: thread t carries columns t, t + 256, ... to its end
  float acc[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = tid + k * kThreads;
    acc[k] = c < d ? add_run(s_prod, last, end0, d, c, 0.0f) : 0.0f;
  }
  for (int32_t c0 = t0 + span0; goes_on; c0 += chunk) {
    __syncthreads();  // every thread is done with the previous chunk
    const int cnt = n - c0 < chunk ? n - c0 : chunk;
    if (tid == 0) s_end = cnt;
    stage_order(order, sinv, n, c0, cnt, s_order, s_slot);
    for (int i = tid; i < cnt; i += kThreads)
      if (s_slot[i + 1] != slot_last) atomicMin(&s_end, i);
    __syncthreads();
    const int end = s_end;
    goes_on = end == cnt && c0 + cnt < n && s_slot[cnt + 1] == slot_last;
    stage_rows(seg, w, end, s_order, s_w, s_seg);
    stage_products<V>(g_bags, end, d, s_prod, s_w, s_seg);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      const int c = tid + k * kThreads;
      if (c < d) acc[k] = add_run(s_prod, 0, end, d, c, acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    const int c = tid + k * kThreads;
    if (c < d) write_run(out, slot_prev, slot_last, acc[k], c, d, n_rows);
  }
}

}  // namespace

// `order` (int64) is a stable argsort of the positions by slot and
// `sorted_inv` (int32) the slots in that order. `tile` (<= 256) sorted
// positions a block and `chunk` (>= tile) positions a staging buffer come
// from ops.segment_grad_plan; a plan whose shared memory passes the 48 KB a
// block gets unasked is refused. Needs n < 2^31 and 0 < d <= 1024 (the
// wrapper checks). Returns cudaGetLastError() so the caller can raise.
extern "C" int segment_grad_launch(const void* g_bags, const void* seg, const void* w,
                                   const void* order, const void* sorted_inv, void* out,
                                   int64_t n, int64_t n_rows, int d, int tile, int chunk,
                                   void* stream) {
  const int smem = layout(tile, chunk, d).bytes;
  if (tile < 1 || tile > kThreads || chunk < tile || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + tile - 1) / tile;
  const unsigned int blocks = static_cast<unsigned int>(tiles > 0 ? tiles : 1);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(g_bags) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gb = static_cast<const float*>(g_bags);
  const auto* sg = static_cast<const int32_t*>(seg);
  const auto* wt = static_cast<const float*>(w);
  const auto* od = static_cast<const int64_t*>(order);
  const auto* si = static_cast<const int32_t*>(sorted_inv);
  auto* o = static_cast<float*>(out);
  const int32_t n32 = static_cast<int32_t>(n);
  if (vec) {
    segment_grad_kernel<4><<<blocks, kThreads, smem, s>>>(gb, sg, wt, od, si, o, n32,
                                                          n_rows, d, tile, chunk);
  } else {
    segment_grad_kernel<1><<<blocks, kThreads, smem, s>>>(gb, sg, wt, od, si, o, n32,
                                                          n_rows, d, tile, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
