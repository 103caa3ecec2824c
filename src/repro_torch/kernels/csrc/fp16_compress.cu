// Routed-gradient fp16 compression of g [m, D] (float32), per row r:
//   s[r] = max_c |g[r, c]|,  q[r, c] = half(g[r, c] / max(s[r], 1e-30)).
//
// Replaces fp16_compress_pallas (src/repro/kernels/grad_compress.py:39).
//
// Bound: bytes. Each element is read once (4 bytes) and written once as a
// half (2 bytes) for an abs, a max and a division. The TPU kernel computes
// a [256, D] block's scales and casts in one VMEM pass. On the training
// path (m = 15,976 rows of D = 10) a call is a few microseconds, so the
// design cuts round trips, fills the card and keeps loads and stores
// whole:
//  - a block owns a tile of `rows` consecutive rows (ops.fp16_compress_plan:
//    a multiple of 8, a block an SM where m allows) and copies its rows*D
//    floats into shared memory with coalesced 16-byte cp.async copies in
//    one round trip (row_stage.cuh), working out its index arithmetic
//    meanwhile;
//  - one thread a row scans its staged row for the amax and writes s (the
//    block's s is one coalesced range) and the row's divisor to shared
//    memory. The max is taken as the earlier kernel's ascending nan_max
//    scan took it: the largest |g|, or where the row holds a NaN the |NaN|
//    of its highest column, payload and all; the scan's start is rotated
//    by row to spread the warp over the banks, which changes no bit;
//  - after a barrier every thread takes consecutive groups of 8 outputs,
//    divides each staged float by its row's divisor (IEEE division, no
//    reciprocal; a zero is its own quotient, with no division) and rounds
//    it with __float2half_rn, as the earlier kernel did, and writes the 8
//    halves as one 16-byte store; row and column advance by steps, without
//    a division an element. Only the last tile can end in fewer than 8
//    outputs, written one by one.
// The build has no --use_fast_math, so division and rounding are IEEE with
// no flush to zero: q is bit for bit the earlier kernel's and the plain
// version's, float16 subnormals included. A row holding a NaN gives s =
// NaN and q NaN, as torch.amax and jnp.max do.
// Where a row is under 9 floats, or eight rows with their divisors pass the
// 48 KB of shared memory a block gets unasked (D > 1,534), the plan sets
// `staged` to 0 and one thread a row reads g directly, as the earlier
// kernel did (with the zero shortcut): on the H100 that ran faster than
// staging at D = 4, 6 and 8 and slower from D = 9 on
// (scripts/torch_compress_bench.py --sweep).
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_stage.cuh"

namespace {

// max that keeps a NaN from its first argument (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The amax of a row scanned from column c0 to D-1, then 0 to c0-1: the
// earlier kernel's amax = nan_max(|row[c]|, amax) over ascending c, from
// 0.0f, kept the largest magnitude, or the last NaN it met, so this keeps
// the NaN of the highest column whatever the order of the scan.
__device__ __forceinline__ float row_amax(const float* row, int d, int c0) {
  float amax = 0.0f, nan = 0.0f;
  int nan_col = -1;
  auto take = [&](int c) {
    const float a = fabsf(row[c]);
    if (a != a) {
      if (c > nan_col) {
        nan_col = c;
        nan = a;
      }
    } else if (a > amax) {
      amax = a;
    }
  };
#pragma unroll 4
  for (int c = c0; c < d; ++c) take(c);
#pragma unroll 4
  for (int c = 0; c < c0; ++c) take(c);
  return nan_col >= 0 ? nan : amax;
}

// x / den, IEEE. The divisor is at least 1e-30, +inf or NaN, so a zero over
// a number is that zero, sign and all, and is returned without dividing.
// On the routed rows, over a third of them empty bucket slots, skipping
// those divisions made the bulk call much faster on the H100; dividing
// 1.0f in their place, with selects, did not.
__device__ __forceinline__ float scaled(float x, float den) {
  if (x == 0.0f && den == den) return x;
  return x / den;
}

__device__ __forceinline__ uint32_t half_pair(float a, float b) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(a))) |
         (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(b))) << 16);
}

__global__ void fp16_compress_kernel_staged(const float* __restrict__ g,
                                            __half* __restrict__ q, float* __restrict__ s,
                                            int64_t m, int d, int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int cnt = static_cast<int>(m - r0 < rows ? m - r0 : rows);
  const int n = cnt * d;
  const int t = threadIdx.x, nt = blockDim.x;
  // shared: the rows' divisors (rows floats, a multiple of 8: the staging
  // buffer after them stays 16-byte aligned), then the staged rows
  float* den = smem;
  const float* x = row_stage_issue(smem + rows, g, r0, cnt, d);
  // while the copies fly: this thread's first group of 8 outputs, its row
  // and column, and those of the stride between its groups
  int e = 8 * t;
  int row = e / d, col = e - row * d;
  const int step = 8 * nt;
  const int drow = step / d, dcol = step - drow * d;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;  // g 16-byte aligned
  fm_stage_wait();
  __syncthreads();
  for (int r = t; r < cnt; r += nt) {
    const float amax = row_amax(x + r * d, d, row_scan_start(d, r));
    den[r] = nan_max(amax, 1e-30f);
    s[r0 + r] = amax;
  }
  __syncthreads();
  __half* qt = q + r0 * d;  // r0 * d halves: 16 * d * (r0 / 8) bytes
  for (int grp = t; grp < (n >> 3); grp += nt) {
    float v[8];
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(x + e);
      const float4 b = *reinterpret_cast<const float4*>(x + e + 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = x[e + i];
    }
    int rr = row, cc = col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = scaled(v[i], den[rr]);
      if (++cc == d) {
        cc = 0;
        ++rr;
      }
    }
    *reinterpret_cast<uint4*>(qt + e) = make_uint4(half_pair(v[0], v[1]), half_pair(v[2], v[3]),
                                                   half_pair(v[4], v[5]), half_pair(v[6], v[7]));
    e += step;
    row += drow;
    col += dcol;
    if (col >= d) {
      col -= d;
      ++row;
    }
  }
  if (t < (n & 7)) {  // the last tile's last n % 8 outputs
    const int et = (n & ~7) + t;
    qt[et] = __float2half_rn(scaled(x[et], den[et / d]));
  }
}

__global__ void fp16_compress_kernel_direct(const float* __restrict__ g,
                                            __half* __restrict__ q, float* __restrict__ s,
                                            int64_t m, int d, int rows) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int cnt = static_cast<int>(m - r0 < rows ? m - r0 : rows);
  for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
    const float* row = g + (r0 + r) * d;
    const float amax = row_amax(row, d, 0);
    const float denom = nan_max(amax, 1e-30f);
    __half* out = q + (r0 + r) * d;
    for (int c = 0; c < d; ++c) out[c] = __float2half_rn(scaled(__ldg(row + c), denom));
    s[r0 + r] = amax;
  }
}

}  // namespace

// Launches on `stream` with ops.fp16_compress_plan's (rows, threads,
// staged); a staged block takes (rows * (D + 1) + 3) floats of shared
// memory, at most 48 KB, and q must be 16-byte aligned. Returns
// cudaGetLastError() so the caller can raise.
extern "C" int fp16_compress_launch(const void* g, void* q, void* s, int64_t m, int d, int rows,
                                    int threads, int staged, void* stream) {
  if (m <= 0 || d <= 0 || rows <= 0 || threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      static_cast<int64_t>(rows) * d > (1 << 28) ||
      (staged && (rows % 8 != 0 || (reinterpret_cast<uintptr_t>(q) & 15u) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (m + rows - 1) / rows;
  const size_t smem = (static_cast<size_t>(rows) * (d + 1) + 3) * sizeof(float);
  if (blocks > 0x7fffffff || (staged && smem > static_cast<size_t>(kRowSmemBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  __half* qp = static_cast<__half*>(q);
  float* sp = static_cast<float*>(s);
  if (staged) {
    fp16_compress_kernel_staged<<<static_cast<unsigned int>(blocks), threads, smem, st>>>(
        gp, qp, sp, m, d, rows);
  } else {
    fp16_compress_kernel_direct<<<static_cast<unsigned int>(blocks), threads, 0, st>>>(
        gp, qp, sp, m, d, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
