// DLRM pairwise dot interaction backward: d/dfields of dot_interaction,
//   out[b, i, :] = sum_j S[i, j] * x[b, j, :],
//   S[i, j] = S[j, i] = g[b, p(min(i, j), max(i, j))], S[i, i] = 0,
// from fields [B, F, D] and the cotangent g [B, P] to [B, F, D]; p(i, j) is
// the np.triu_indices(F, k=1) position of the pair. This is the reference's
// (gZ + gZ^T) @ x with gZ the cotangent scattered into the strict upper
// triangle.
//
// Replaces dot_interaction_bwd_pallas (src/repro/kernels/interaction_bwd.py:89).
//
// Bound: bytes. At DLRM's F = 27, D = 128 it moves 2*B*F*D + B*P floats
// (1.90 GB at B = 65,536: 0.568 ms at 3.35 TB/s), while its 2*B*F*(F-1)*D
// flops take a third of that at float32 FMA rates, so tensor cores (wgmma,
// mma.sync) would buy nothing; what matters is how the FMAs are fed and
// that device memory never waits. The TPU kernel scatters g into a [F, F]
// block with a 0/1 selection matmul and multiplies on the MXU. Here:
//  - persistent blocks walk their groups of `spb` samples through the
//    cp.async ring of dot_ring.cuh (16-byte copies where the rows are
//    16-byte aligned, else 4-byte), so the next samples load while this
//    one computes;
//  - the block builds the pair table p -> (i, j) once, and each sample's P
//    cotangents, copied in coalesced, are written to S[i][j] and S[j][i]
//    of a zero-diagonal S whose rows are padded to a multiple of 4: no
//    integer division per entry;
//  - a thread owns a 4 x 4 register tile (rows i of a row tile, 4
//    consecutive d). At each j it reads x[j, d:d+4] and S[j, i:i+4] as two
//    16-byte shared loads and does 16 independent FMAs (two loads per 16
//    FMAs). The 32 threads of a warp take 32 consecutive column groups, so
//    x's loads and the output's 16-byte stores are contiguous and S's
//    load is a broadcast.
// Each output element sums j in ascending order from +0.0f with fmaf,
// multiplying the diagonal by its exact zero: for finite inputs that is
// bit for bit the skip of j == i, and so the previous kernel's result. No
// atomics and a fixed order: the result repeats bit for bit.
#include "dot_ring.cuh"

namespace {

using dot_ring::cp16;
using dot_ring::cp4;
using dot_ring::up4;

// The shared-memory layout, in floats: the pair table, S [spb, F, Fp], then
// `stages` buffers of (rows [spb, F, Dp], cotangents [spb * P]).
struct Layout {
  int f, d, fp, dp, p, spb;
  __host__ __device__ Layout(int f_, int d_, int spb_)
      : f(f_), d(d_), fp(up4(f_)), dp(up4(d_)), p(f_ * (f_ - 1) / 2), spb(spb_) {}
  __host__ __device__ int s_off() const { return up4(p); }
  __host__ __device__ int rows_len() const { return spb * f * dp; }
  __host__ __device__ int stage_off() const { return s_off() + spb * f * fp; }
  __host__ __device__ int stage_len() const { return rows_len() + up4(spb * p); }
  __host__ __device__ size_t bytes(int stages) const {
    return 4 * (static_cast<size_t>(stage_off()) + static_cast<size_t>(stages) * stage_len());
  }
};

template <int kStages>
__global__ void __launch_bounds__(256) dot_interaction_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ out,
    int64_t b, Layout L, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int f = L.f, d = L.d, fp = L.fp, dp = L.dp, p = L.p, spb = L.spb;
  const int col_groups = dp / 4, items = (fp / 4) * col_groups;
  int* pairs = reinterpret_cast<int*>(smem);  // [P]: i << 16 | j
  float* S = smem + L.s_off();
  float* ring = smem + L.stage_off();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t n_it = dot_ring::block_iters(b, spb);

  // row i of the triangle starts at i*F - i*(i+1)/2; built once a block
  for (int i = tid; i < f; i += nt) {
    const int base = i * f - i * (i + 1) / 2 - i - 1;
    for (int j = i + 1; j < f; ++j) pairs[base + j] = (i << 16) | j;
  }
  for (int e = tid; e < spb * f * fp; e += nt) S[e] = 0.0f;  // diagonal and padding stay 0

  auto load = [&](int64_t it) {
    if (it >= n_it) return;
    const int64_t b0 = dot_ring::first_sample(it, spb);
    const int ns = static_cast<int>(b - b0 < spb ? b - b0 : spb);
    float* xs = ring + static_cast<int>(it % kStages) * L.stage_len();
    float* gs = xs + L.rows_len();
    const float* xg = x + b0 * f * d;
    if (vec) {  // the group's rows are contiguous, and so is their copy (dp == d)
      const int n4 = ns * f * d / 4;
      for (int v = tid; v < n4; v += nt) cp16(xs + 4 * v, xg + 4 * v);
    } else {  // a warp a row, its lanes along d; pad columns are never stored
      for (int r = tid / 32; r < ns * f; r += nt / 32)
        for (int c = tid % 32; c < d; c += 32) cp4(xs + r * dp + c, xg + r * d + c);
    }
    const float* gg = g + b0 * p;
    for (int e = tid; e < ns * p; e += nt) cp4(gs + e, gg + e);
  };

  // on entry S and the previous group's buffer are free
  dot_ring::walk<kStages>(n_it, load, [&](int64_t it) {
    const int64_t b0 = dot_ring::first_sample(it, spb);
    const int ns = static_cast<int>(b - b0 < spb ? b - b0 : spb);
    const float* xs = ring + static_cast<int>(it % kStages) * L.stage_len();
    const float* gs = xs + L.rows_len();
    for (int s = 0; s < ns; ++s) {
      float* Ss = S + s * f * fp;
      for (int q = tid; q < p; q += nt) {
        const float v = gs[s * p + q];
        const int ij = pairs[q], i = ij >> 16, j = ij & 0xffff;
        Ss[i * fp + j] = v;
        Ss[j * fp + i] = v;
      }
    }
    __syncthreads();
    for (int t = tid; t < ns * items; t += nt) {
      const int s = t / items, r = t - s * items;
      const int rt = r / col_groups, cg = r - rt * col_groups;
      const float* xr = xs + s * f * dp + 4 * cg;
      const float* sr = S + s * f * fp + 4 * rt;
      float a[4][4] = {};
#pragma unroll 3
      for (int j = 0; j < f; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + j * dp);
        const float4 sv = *reinterpret_cast<const float4*>(sr + j * fp);
        const float xc[4] = {xv.x, xv.y, xv.z, xv.w}, sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) a[u][c] = fmaf(sc[u], xc[c], a[u][c]);
      }
      float* ob = out + ((b0 + s) * f + 4 * rt) * d + 4 * cg;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * rt + u >= f) break;
        if (vec) {
          __stcs(reinterpret_cast<float4*>(ob + u * d),
                 make_float4(a[u][0], a[u][1], a[u][2], a[u][3]));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * cg + c < d) ob[u * d + c] = a[u][c];
        }
      }
    }
  });
}

template <int kStages>
cudaError_t launch(const float* x, const float* g, float* out, int64_t b, Layout L,
                   int threads, size_t smem, cudaStream_t stream) {
  auto kern = dot_interaction_bwd_kernel<kStages>;
  static dot_ring::LaunchCache cache;
  int64_t grid = 0;
  const cudaError_t err =
      dot_ring::persistent_grid(kern, threads, smem, (b + L.spb - 1) / L.spb, cache, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = L.d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kern<<<static_cast<unsigned int>(grid), threads, smem, stream>>>(x, g, out, b, L, vec);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream`; returns the first CUDA error of the launch (so the
// caller can raise). `spb` samples a group, `stages` (2 or 3) ring buffers,
// `threads` (a multiple of 32, at most 256) and `smem` come from the
// wrapper's plan (ops.dot_bwd_plan); `smem` must be the layout's size, and
// the wrapper launches only for B > 0, F > 0 and D > 0.
extern "C" int dot_interaction_bwd_launch(const void* x, const void* g, void* out,
                                          int64_t b, int f, int d, int spb, int stages,
                                          int threads, int64_t smem, void* stream) {
  if (b <= 0 || f <= 0 || d <= 0 || spb <= 0 || threads <= 0 || threads > 256 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(f, d, spb);
  if (smem != static_cast<int64_t>(L.bytes(stages)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = stages == 3   ? launch<3>(xp, gp, op, b, L, threads, smem, st)
                    : stages == 2 ? launch<2>(xp, gp, op, b, L, threads, smem, st)
                                  : cudaErrorInvalidValue;
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
