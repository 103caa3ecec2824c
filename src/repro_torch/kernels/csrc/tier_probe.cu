// Fused cache-tier probe for the HybridHash tiers.
//
// Replaces tier_probe_pallas (src/repro/kernels/fused_embedding.py:279).
// Per query u: slot = min(#(keys < u), H - 1) over the sorted tier keys,
// hit = keys[slot] == u && uvalid, and the hit row of the tier (exact zeros
// on a miss), so the caller's stitch is one `where`.
//
// Bound: bytes, and in practice latency. Each query reads a few keys, one
// D-float row on a hit, and writes 1 + 4 + 4*D bytes; there is no
// arithmetic. The TPU kernel ranks by counting over the whole key vector
// held in VMEM, O(n*H). A binary search in device memory is a chain of
// ceil(log2 H) dependent loads, 22 on a 4.19 M-key tier, and the path's
// 10,000-20,000 queries are too few to hide it. Two searches cut the chain:
//   - k-ary (lanes > 1, the path's shapes): a group of `lanes` threads a
//     query reads `lanes` pivots at once and a ballot picks the sub-range,
//     ceil(log_{lanes+1} H) dependent loads (5 at 32 lanes on 4.19 M keys,
//     7 at 8); the last level reads one contiguous run of keys, and the
//     first level's pivots are read beside the query. ops picks the most
//     lanes for which all queries' groups fit in 40 warps an SM;
//   - ranged (lanes == 1, bulk): a block of 256 queries finds the key range
//     its smallest and largest query span (two 33-ary warp searches), stages
//     that range in shared memory when it fits (sorted queries, as the
//     unique gives them, span a few hundred keys) and each thread binary-
//     searches it there; otherwise in device memory, within the range.
//     Right for unsorted queries too, only slower.
// The hit rows are copied 16 bytes a load where rows are 16-byte aligned
// (D % 4 == 0), neighbouring threads on neighbouring addresses.
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageKeys = 4096;  // keys a ranged block stages (16 KB)

// The first level's pivot of lane `lane` of a `G`-lane search over all h
// keys: it does not depend on the query, so it is read beside it.
template <int G>
__device__ __forceinline__ int32_t first_pivot(const int32_t* __restrict__ keys, int64_t h,
                                               int lane) {
  return h >= G ? keys[(lane + 1) * static_cast<uint64_t>(h) / (G + 1)] : 0;
}

// Lower bound of u in keys[0, h) by the `G` lanes of a group (lane `lane`,
// group mask `mask`): a (G + 1)-ary search, `first` this lane's first
// pivot. Each level keeps keys[lo - 1] < u <= keys[hi] (where they exist).
// Returns the bound; `*key` gets keys[bound] (INT_MAX when bound == h).
template <int G>
__device__ __forceinline__ int64_t kary_lower_bound(const int32_t* __restrict__ keys,
                                                    int64_t h, int32_t u, int lane,
                                                    unsigned mask, int32_t first,
                                                    int32_t* key) {
  int64_t lo = 0, hi = h;
  for (bool top = true; hi - lo >= G; top = false) {
    const uint64_t len = static_cast<uint64_t>(hi - lo);
    const int32_t pivot = top ? first : keys[lo + (lane + 1) * len / (G + 1)];
    const int c = __popc(__ballot_sync(mask, pivot < u) & mask);  // pivots below u
    const int64_t lo_n = c == 0 ? lo : lo + static_cast<int64_t>(c * len / (G + 1)) + 1;
    hi = c == G ? hi : lo + static_cast<int64_t>((c + 1) * len / (G + 1));
    lo = lo_n;
  }
  // hi - lo < G: lanes 0 .. hi - lo read keys[lo .. hi] in one run
  const int64_t q = lo + lane;
  const int32_t k = lane <= hi - lo && q < h ? keys[q] : INT_MAX;
  const int c = __popc(__ballot_sync(mask, lane < hi - lo && k < u) & mask);
  *key = __shfl_sync(mask, k, c, G);
  return lo + c;
}

// Copies (or zeroes) the D floats of one query's row with `G` lanes.
template <int G, int V>
__device__ __forceinline__ void copy_row(const float* __restrict__ rows,
                                         float* __restrict__ rows_out, int64_t q,
                                         int64_t slot, bool hit, int d, int lane) {
  if constexpr (V == 4) {
    const float4* src = reinterpret_cast<const float4*>(rows + slot * d);
    float4* dst = reinterpret_cast<float4*>(rows_out + q * d);
    for (int c = lane; c < d / 4; c += G)
      dst[c] = hit ? src[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int c = lane; c < d; c += G) rows_out[q * d + c] = hit ? rows[slot * d + c] : 0.0f;
  }
}

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
tier_probe_kary_kernel(const int32_t* __restrict__ uniq,
                       const uint8_t* __restrict__ uvalid,
                       const int32_t* __restrict__ keys, const float* __restrict__ rows,
                       uint8_t* __restrict__ hit_out, int32_t* __restrict__ slot_out,
                       float* __restrict__ rows_out, int64_t n, int64_t h, int d) {
  const int64_t q = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (q >= n) return;  // a group leaves whole: its lanes share q
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int32_t first = first_pivot<G>(keys, h, lane);
  const int32_t u = uniq[q];
  const bool valid = uvalid[q] != 0;
  int32_t key;
  const int64_t lb = kary_lower_bound<G>(keys, h, u, lane, mask, first, &key);
  const int64_t slot = lb < h - 1 ? lb : h - 1;
  const bool hit = valid && lb < h && key == u;
  if (lane == 0) {
    hit_out[q] = hit ? 1 : 0;
    slot_out[q] = static_cast<int32_t>(slot);
  }
  copy_row<G, V>(rows, rows_out, q, slot, hit, d, lane);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
tier_probe_ranged_kernel(const int32_t* __restrict__ uniq,
                         const uint8_t* __restrict__ uvalid,
                         const int32_t* __restrict__ keys, const float* __restrict__ rows,
                         uint8_t* __restrict__ hit_out, int32_t* __restrict__ slot_out,
                         float* __restrict__ rows_out, int64_t n, int64_t h, int d) {
  __shared__ int32_t s_keys[kStageKeys];
  __shared__ int32_t s_min[kThreads / 32], s_max[kThreads / 32], s_slot[kThreads];
  __shared__ uint8_t s_hit[kThreads];
  __shared__ int64_t s_range[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t q = q0 + tid;
  const int32_t first = warp < 2 ? first_pivot<32>(keys, h, lane) : 0;
  const int32_t u = q < n ? uniq[q] : 0;
  // 1. the block's smallest and largest query
  const int lo_u = __reduce_min_sync(0xffffffffu, q < n ? u : INT_MAX);
  const int hi_u = __reduce_max_sync(0xffffffffu, q < n ? u : INT_MIN);
  if (lane == 0) {
    s_min[warp] = lo_u;
    s_max[warp] = hi_u;
  }
  __syncthreads();
  // 2. warp 0 finds lower_bound(min), warp 1 lower_bound(max): every query's
  //    bound lies between them
  if (warp < 2) {
    int32_t v = warp == 0 ? INT_MAX : INT_MIN;
    for (int k = 0; k < kThreads / 32; ++k)
      v = warp == 0 ? min(v, s_min[k]) : max(v, s_max[k]);
    int32_t key;
    const int64_t b = kary_lower_bound<32>(keys, h, v, lane, 0xffffffffu, first, &key);
    if (lane == 0) s_range[warp] = b;
  }
  __syncthreads();
  const int64_t lo = s_range[0], hi = s_range[1];
  // keys[lo .. min(hi, h - 1)] hold every key a query of the block compares
  const int64_t span = (hi < h ? hi : h - 1) - lo + 1;
  const bool staged = span <= kStageKeys;
  if (staged) {
    for (int64_t i = tid; i < span; i += kThreads) s_keys[i] = keys[lo + i];
    __syncthreads();
  }
  // 3. each query's lower bound in [lo, hi]
  if (q < n) {
    int64_t a = lo, b = hi;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if ((staged ? s_keys[mid - lo] : keys[mid]) < u) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    const int64_t slot = a < h - 1 ? a : h - 1;
    const bool hit =
        uvalid[q] != 0 && a < h && (staged ? s_keys[a - lo] : keys[a]) == u;
    hit_out[q] = hit ? 1 : 0;
    slot_out[q] = static_cast<int32_t>(slot);
    s_slot[tid] = static_cast<int32_t>(slot);
    s_hit[tid] = hit ? 1 : 0;
  }
  __syncthreads();
  // 4. the block's rows, the whole block on each row in turn
  const int64_t nq = n - q0 < kThreads ? n - q0 : kThreads;
  const int dv = d / V;
  for (int64_t e = tid; e < nq * dv; e += kThreads) {
    const int64_t i = e / dv, c = e - i * dv;
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(rows_out + (q0 + i) * d)[c] =
          s_hit[i] ? reinterpret_cast<const float4*>(
                         rows + static_cast<int64_t>(s_slot[i]) * d)[c]
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      rows_out[(q0 + i) * d + c] =
          s_hit[i] ? rows[static_cast<int64_t>(s_slot[i]) * d + c] : 0.0f;
    }
  }
}

template <int V>
void launch(int lanes, const int32_t* uniq, const uint8_t* uvalid, const int32_t* keys,
            const float* rows, uint8_t* hit, int32_t* slot, float* out, int64_t n,
            int64_t h, int d, cudaStream_t s) {
  const unsigned int blocks =
      static_cast<unsigned int>((n * lanes + kThreads - 1) / kThreads);
  switch (lanes) {
#define TIER_PROBE_KARY(G)                                                     \
  case G:                                                                      \
    tier_probe_kary_kernel<G, V><<<blocks, kThreads, 0, s>>>(                  \
        uniq, uvalid, keys, rows, hit, slot, out, n, h, d);                    \
    break;
    TIER_PROBE_KARY(2)
    TIER_PROBE_KARY(4)
    TIER_PROBE_KARY(8)
    TIER_PROBE_KARY(16)
    TIER_PROBE_KARY(32)
#undef TIER_PROBE_KARY
    default:
      tier_probe_ranged_kernel<V><<<blocks, kThreads, 0, s>>>(uniq, uvalid, keys, rows,
                                                              hit, slot, out, n, h, d);
  }
}

}  // namespace

// `lanes` (1, 2, 4, 8, 16 or 32) from ops.tier_probe_plan: 1 runs the ranged
// search, any other the k-ary one with that many lanes a query. Needs
// h >= 1 (the wrapper checks). Launches on `stream`; returns
// cudaGetLastError() so the caller can raise.
extern "C" int tier_probe_launch(const void* uniq, const void* uvalid, const void* keys,
                                 const void* rows, void* hit, void* slot, void* rows_out,
                                 int64_t n, int64_t h, int d, int lanes, void* stream) {
  const auto* u = static_cast<const int32_t*>(uniq);
  const auto* v = static_cast<const uint8_t*>(uvalid);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<float*>(rows_out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows_out) % 16 == 0;
  if (vec) {
    launch<4>(lanes, u, v, k, r, static_cast<uint8_t*>(hit), static_cast<int32_t*>(slot),
              o, n, h, d, s);
  } else {
    launch<1>(lanes, u, v, k, r, static_cast<uint8_t*>(hit), static_cast<int32_t*>(slot),
              o, n, h, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
