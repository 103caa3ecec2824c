// Narrow-row stitch of the picasso_narrow lookup: gather the [d]-narrow rows
// out of the routed-back buffer and project them up through the learned
// [d, D] map,
//   narrow[i] = ok(i) ? back[idx[i]] : 0,   wide[i] = narrow[i] @ proj,
// with ok(i) = kept[i] && 0 <= idx[i] < m; both outputs are exact zeros
// where ok(i) is false.
//
// Replaces gather_project_pallas (src/repro/kernels/fused_embedding.py:351),
// which runs one grid step per position: a DMA of the narrow row, then an
// MXU product with the VMEM-resident projection.
//
// Bound: bytes. Per position it reads idx, kept and d floats of `back`, and
// writes D + d floats; 2*d*D flops (at DLRM's d = 32, D = 128 a third of
// the bytes' time at the float32 rate). At the paths' shapes a call
// is a few microseconds of dependent latency, so a block owns a tile of
// `tile` positions (ops.gather_project_plan) and each position is one
// dependent chain:
//  - the block first puts the copy of proj into shared memory in flight
//    (cp.async), then a group of d / W lanes a position (W = 4, 2 or 1
//    floats a lane) reads the position's idx and kept (coalesced: the
//    group's lanes read one address) and at once its narrow row as W-float
//    vector loads, up to four positions a lane with all their loads issued
//    before any is used. The narrow output is written from those registers
//    as W-float vector stores, and the rows are staged in shared memory;
//  - one barrier, which also completes proj's copy; then the product:
//    D / CW lanes a position, each owning CW consecutive columns of `rows`
//    positions of the tile at once, in as many rounds as the tile needs (a
//    warp spans one position's 128 columns at DLRM's D = 128, and each proj
//    vector read from shared memory serves all `rows`). Each column sums
//    k = 0..d-1 ascending with fmaf from +0.0f, as the kernel this replaced
//    did, so both outputs are bit for bit its own. Lane t owns columns
//    [CW*t, CW*t + CW) of its positions counted from the tile's first, so a
//    warp's CW-float stores of `wide` are one contiguous run: coalesced
//    without staging, and with no division by d or D per element.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGatherBatch = 4;  // positions a lane gathers at once, at most

template <int W>
struct alignas(4 * W) Vec {
  float v[W];
};

__host__ __device__ constexpr int up4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

struct Args {
  const float* back;
  const int32_t* idx;
  const uint8_t* kept;
  const float* proj;
  float* wide;
  float* narrow;
  int64_t m, n;
  int nd, d, tile;
};

// shared memory: proj [nd * d], the tile's rows [tile * nd], ok [tile]
__host__ __device__ inline size_t smem_bytes(int nd, int d, int tile) {
  return static_cast<size_t>(up4(nd * d) + up4(tile * nd)) * sizeof(float) + tile;
}

template <int W, int CW, int R>
__global__ void gather_project_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* s_proj = reinterpret_cast<float*>(smem4);
  float* s_rows = s_proj + up4(a.nd * a.d);
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_rows + up4(a.tile * a.nd));
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * a.tile;
  const int cnt = static_cast<int>(a.n - p0 < a.tile ? a.n - p0 : a.tile);

  // proj's copy, in flight while the gather below waits on device memory
  const int pd = a.nd * a.d;
  if ((pd & 3) == 0 && (reinterpret_cast<uintptr_t>(a.proj) & 15u) == 0) {
    for (int e = 4 * tid; e < pd; e += 4 * nt) cp16(s_proj + e, a.proj + e);
  } else {
    for (int e = tid; e < pd; e += nt) cp4(s_proj + e, a.proj + e);
  }

  // the gather: G lanes a position, per_pass positions a pass of the block
  const int G = a.nd / W;
  const int per_pass = nt / G;
  const int gp = tid / G, j = tid - gp * G;
  const Vec<W>* back_v = reinterpret_cast<const Vec<W>*>(a.back);
  Vec<W>* narrow_v = reinterpret_cast<Vec<W>*>(a.narrow);
  Vec<W>* rows_v = reinterpret_cast<Vec<W>*>(s_rows);
  if (gp < per_pass) {
    for (int base = gp; base < cnt; base += kGatherBatch * per_pass) {
      int32_t ix[kGatherBatch];
      bool ok[kGatherBatch];
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int p = base + u * per_pass;
        ok[u] = p < cnt && a.kept[p0 + p] != 0;
        ix[u] = p < cnt ? a.idx[p0 + p] : 0;
      }
      Vec<W> v[kGatherBatch];
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        ok[u] = ok[u] && ix[u] >= 0 && ix[u] < a.m;
#pragma unroll
        for (int c = 0; c < W; ++c) v[u].v[c] = 0.0f;
        if (ok[u]) v[u] = back_v[static_cast<int64_t>(ix[u]) * G + j];
      }
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int p = base + u * per_pass;
        if (p < cnt) {
          narrow_v[(p0 + p) * G + j] = v[u];
          rows_v[p * G + j] = v[u];
          if (j == 0) s_ok[p] = ok[u] ? 1 : 0;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the product: NC lanes a position, Q position slots, R positions a slot
  const int NC = a.d / CW;
  const int Q = nt / NC;
  const int q = tid / NC, c0 = (tid - q * NC) * CW;
  if (q >= Q) return;
  for (int base = q; base < cnt; base += R * Q) {
    const float* rp[R];
    float acc[R][CW];
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const int p = base + g * Q;
      rp[g] = s_rows + (p < cnt ? p : base) * a.nd;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[g][c] = 0.0f;
    }
    for (int k = 0; k < a.nd; k += W) {
      Vec<W> r[R];
#pragma unroll
      for (int g = 0; g < R; ++g) r[g] = *reinterpret_cast<const Vec<W>*>(rp[g] + k);
#pragma unroll
      for (int kk = 0; kk < W; ++kk) {
        const Vec<CW> pv = *reinterpret_cast<const Vec<CW>*>(s_proj + (k + kk) * a.d + c0);
#pragma unroll
        for (int g = 0; g < R; ++g) {
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[g][c] = fmaf(r[g].v[kk], pv.v[c], acc[g][c]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const int p = base + g * Q;
      if (p < cnt) {
        Vec<CW> o;
        const bool ok = s_ok[p] != 0;
#pragma unroll
        for (int c = 0; c < CW; ++c) o.v[c] = ok ? acc[g][c] : 0.0f;
        *reinterpret_cast<Vec<CW>*>(a.wide + (p0 + p) * a.d + c0) = o;
      }
    }
  }
}

template <int W, int CW, int R>
void launch(const Args& a, unsigned int blocks, int threads, size_t smem, cudaStream_t st) {
  gather_project_kernel<W, CW, R><<<blocks, threads, smem, st>>>(a);
}

template <int W, int CW>
cudaError_t by_rows(int rows, const Args& a, unsigned int blocks, int threads, size_t smem,
                    cudaStream_t st) {
  switch (rows) {
    case 1: launch<W, CW, 1>(a, blocks, threads, smem, st); break;
    case 2: launch<W, CW, 2>(a, blocks, threads, smem, st); break;
    case 4: launch<W, CW, 4>(a, blocks, threads, smem, st); break;
    case 8: launch<W, CW, 8>(a, blocks, threads, smem, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int W>
cudaError_t by_cw(int cw, int rows, const Args& a, unsigned int blocks, int threads,
                  size_t smem, cudaStream_t st) {
  switch (cw) {
    case 1: return by_rows<W, 1>(rows, a, blocks, threads, smem, st);
    case 2: return by_rows<W, 2>(rows, a, blocks, threads, smem, st);
    case 4: return by_rows<W, 4>(rows, a, blocks, threads, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int w) {
  return (reinterpret_cast<uintptr_t>(p) & static_cast<uintptr_t>(4 * w - 1)) == 0;
}

}  // namespace

// Launches on `stream` with ops.gather_project_plan's (w, cw, rows,
// threads, tile): `back` and `narrow` aligned to w floats and `wide` to cw,
// w | d, cw | D, d / w and D / cw at most `threads`, shared memory within
// 48 KB. Returns cudaGetLastError() (or cudaErrorInvalidValue for a plan
// the kernel does not take) so the caller can raise.
extern "C" int gather_project_launch(const void* back, const void* idx, const void* kept,
                                     const void* proj, void* wide, void* narrow, int64_t m,
                                     int64_t n, int nd, int d, int w, int cw, int rows,
                                     int threads, int tile, void* stream) {
  if (n <= 0 || nd <= 0 || d <= 0 || tile <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0 || w <= 0 || cw <= 0 || nd % w != 0 || d % cw != 0 ||
      nd / w > threads || d / cw > threads || !aligned(back, w) || !aligned(narrow, w) ||
      !aligned(wide, cw) || smem_bytes(nd, d, tile) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(back), static_cast<const int32_t*>(idx),
               static_cast<const uint8_t*>(kept), static_cast<const float*>(proj),
               static_cast<float*>(wide), static_cast<float*>(narrow), m, n, nd, d, tile};
  const unsigned int nb = static_cast<unsigned int>(blocks);
  const size_t smem = smem_bytes(nd, d, tile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 1: err = by_cw<1>(cw, rows, a, nb, threads, smem, st); break;
    case 2: err = by_cw<2>(cw, rows, a, nb, threads, smem, st); break;
    case 4: err = by_cw<4>(cw, rows, a, nb, threads, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
