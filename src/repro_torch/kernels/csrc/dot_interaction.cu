// DLRM pairwise dot interaction: [B, F, D] -> [B, P], P = F(F-1)/2,
//   out[b, p(i, j)] = sum_d x[b, i, d] * x[b, j, d]   for i < j,
// with the pairs in np.triu_indices(F, k=1) order (row-major).
//
// Replaces dot_interaction_pallas (src/repro/kernels/dot_interaction.py:37).
//
// Bound: bytes. At DLRM's F = 27, D = 128 it reads B*F*D floats once and
// writes B*P (0.298 ms at B = 65,536 and 3.35 TB/s), while its 2*B*P*D
// flops fit under a third of that at float32 FMA rates; tensor cores would
// buy nothing, and 3xTF32 would change the sums' bits. The TPU kernel forms
// the full X X^T on the MXU and extracts the triangle with a [F*F, P] 0/1
// selection matmul, because gathers are slow on its vector unit. Here:
//  - persistent blocks walk groups of `spb` samples through the cp.async
//    ring of dot_ring.cuh, so the next samples load while this group
//    computes. A sample's rows sit in shared memory padded to Fp = up4(F)
//    rows of Dp = up4(D) floats (the pad stays zero), each row's 16-byte
//    column groups XOR-swizzled by its row tile, so that the threads of a
//    quarter warp, which read the same column group of rows T apart, hit
//    different banks;
//  - a thread owns a T x T register tile of the F x F triangle (rows
//    T*ti.., columns T*tj.., tj >= ti; a diagonal tile masks its lower half
//    on the way out). Per 4 d it reads 2T float4s from shared memory and
//    runs T*T independent fmaf chains. T = 4 takes a quarter of the
//    one-pair-a-thread kernel's shared reads a dot; where the batch gives
//    each SM at most two samples (ops.dot_fwd_plan), a block's time is its
//    threads' fmaf chains, and T = 2 spreads a sample's 351 dots over 105
//    threads rather than 28, a quarter of the chain a thread;
//  - the tile's dots go to a staging buffer in shared memory and leave as
//    the group's contiguous [ns, P] output rows, coalesced.
// Each pair sums d in ascending order from +0.0f with fmaf, as the
// one-pair-a-thread kernel did; the pad's 0 * 0 leaves a sum that is never
// -0.0 unchanged, so the result is bit for bit that kernel's. No atomics
// and a fixed order: the result repeats bit for bit.
#include "dot_ring.cuh"

namespace {

using dot_ring::cp16;
using dot_ring::cp4;
using dot_ring::up4;

// The shared-memory layout, in floats: `stages` buffers of rows
// [spb, Fp, Dp], then the output stage [spb * P]. `shift` is log2 of the
// tile side T.
struct Layout {
  int f, d, fp, dp, p, tiles, spb, swz, shift;
  __host__ __device__ Layout(int f_, int d_, int spb_, int t)
      : f(f_), d(d_), fp(up4(f_)), dp(up4(d_)), p(f_ * (f_ - 1) / 2),
        tiles((up4(f_) / t) * (up4(f_) / t + 1) / 2), spb(spb_), swz(swizzle(up4(d_) / 4)),
        shift(t == 4 ? 2 : 1) {}
  // the largest mask 2^k - 1 <= 7 that keeps a row's column groups in the row
  __host__ __device__ static int swizzle(int groups) {
    return groups % 8 == 0 ? 7 : groups % 4 == 0 ? 3 : groups % 2 == 0 ? 1 : 0;
  }
  __host__ __device__ int stage_len() const { return spb * fp * dp; }
  __host__ __device__ int out_off(int stages) const { return stages * stage_len(); }
  __host__ __device__ size_t bytes(int stages) const {
    return 4 * (static_cast<size_t>(out_off(stages)) + static_cast<size_t>(up4(spb * p)));
  }
  __device__ __forceinline__ int key(int row) const { return (row >> shift) & swz; }
  // float offset of column group c of row r of sample s in a buffer
  __device__ __forceinline__ int at(int s, int r, int c) const {
    const int row = s * fp + r;
    return row * dp + 4 * (c ^ key(row));
  }
};

template <int kStages, int T>
__global__ void __launch_bounds__(256) dot_interaction_kernel(const float* __restrict__ x,
                                                              float* __restrict__ out,
                                                              int64_t b, Layout L, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int f = L.f, d = L.d, p = L.p, tiles = L.tiles, spb = L.spb;
  float* ring = smem;
  float* staged = smem + L.out_off(kStages);
  const int tid = threadIdx.x, nt = blockDim.x;
  // pad rows and columns stay zero: the copies below write the same slots
  // of every buffer, and never these. `bs` counts (buffer, sample) pairs
  const int fp = L.fp, dp = L.dp, pad_rows = fp - f, pad_cols = dp - d;
  for (int e = tid; e < kStages * spb * pad_rows * dp; e += nt) {
    const int row = e / dp, bs = row / pad_rows;
    ring[(bs * fp + f + row - bs * pad_rows) * dp + e - row * dp] = 0.0f;
  }
  for (int e = tid; e < kStages * spb * f * pad_cols; e += nt) {
    const int row = e / pad_cols, bs = row / f, c = d + e - row * pad_cols;
    const int s = bs % spb, r = row - bs * f;
    ring[(bs / spb) * L.stage_len() + L.at(s, r, c >> 2) + (c & 3)] = 0.0f;
  }
  __syncthreads();

  const int64_t n_it = dot_ring::block_iters(b, spb);
  auto load = [&](int64_t it) {
    if (it >= n_it) return;
    const int64_t b0 = dot_ring::first_sample(it, spb);
    const int ns = static_cast<int>(b - b0 < spb ? b - b0 : spb);
    float* xs = ring + static_cast<int>(it % kStages) * L.stage_len();
    const float* xg = x + b0 * f * d;
    // a warp a row, its lanes along d
    for (int r = tid / 32; r < ns * f; r += nt / 32) {
      const int s = r / f, fr = r - s * f;
      if (vec) {
        for (int c = tid % 32; c < d / 4; c += 32) cp16(xs + L.at(s, fr, c), xg + r * d + 4 * c);
      } else {
        for (int c = tid % 32; c < d; c += 32)
          cp4(xs + L.at(s, fr, c >> 2) + (c & 3), xg + r * d + c);
      }
    }
  };

  dot_ring::walk<kStages>(n_it, load, [&](int64_t it) {
    const int64_t b0 = dot_ring::first_sample(it, spb);
    const int ns = static_cast<int>(b - b0 < spb ? b - b0 : spb);
    const float* xs = ring + static_cast<int>(it % kStages) * L.stage_len();
    for (int t = tid; t < ns * tiles; t += nt) {
      // tile k of sample s: row tile ti of the triangle holds fp / T - ti tiles
      const int s = t / tiles;
      int ti = 0, k = t - s * tiles;
      while (k >= fp / T - ti) {
        k -= fp / T - ti;
        ++ti;
      }
      const int tj = ti + k;
      const int ri = s * fp + T * ti, rj = s * fp + T * tj;  // rows in the buffer
      const int ki = L.key(ri), kj = L.key(rj);
      const float* pi = xs + ri * dp;
      const float* pj = xs + rj * dp;
      float a[T][T] = {};
      for (int c = 0; c < dp / 4; ++c) {
        const int oi = 4 * (c ^ ki), oj = 4 * (c ^ kj);
        float xi[T][4], xj[T][4];
#pragma unroll
        for (int u = 0; u < T; ++u) {
          const float4 vi = *reinterpret_cast<const float4*>(pi + u * dp + oi);
          const float4 vj = *reinterpret_cast<const float4*>(pj + u * dp + oj);
          xi[u][0] = vi.x; xi[u][1] = vi.y; xi[u][2] = vi.z; xi[u][3] = vi.w;
          xj[u][0] = vj.x; xj[u][1] = vj.y; xj[u][2] = vj.z; xj[u][3] = vj.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < T; ++u)
#pragma unroll
            for (int v = 0; v < T; ++v) a[u][v] = fmaf(xi[u][e], xj[v][e], a[u][v]);
      }
      float* so = staged + s * p;
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const int i = T * ti + u;
        // row i of the triangle starts at i*F - i*(i+1)/2
        const int row = i * f - i * (i + 1) / 2 - i - 1;
#pragma unroll
        for (int v = 0; v < T; ++v) {
          const int j = T * tj + v;
          if (i < j && j < f) so[row + j] = a[u][v];
        }
      }
    }
    __syncthreads();
    float* og = out + b0 * p;
    for (int e = tid; e < ns * p; e += nt) __stcs(og + e, staged[e]);
  });
}

template <int kStages, int T>
cudaError_t launch(const float* x, float* out, int64_t b, Layout L, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kern = dot_interaction_kernel<kStages, T>;
  static dot_ring::LaunchCache cache;
  int64_t grid = 0;
  const cudaError_t err =
      dot_ring::persistent_grid(kern, threads, smem, (b + L.spb - 1) / L.spb, cache, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = L.d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kern<<<static_cast<unsigned int>(grid), threads, smem, stream>>>(x, out, b, L, vec);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream`; returns the first CUDA error of the launch (so the
// caller can raise). `spb` samples a group, `stages` (2 or 3) ring buffers,
// `threads` (a multiple of 32, at most 256), `smem` and the tile side
// `tile` (2 or 4) come from the wrapper's plan (ops.dot_fwd_plan); `smem`
// must be the layout's size, and the wrapper launches only for B > 0,
// F > 1 and D > 0.
extern "C" int dot_interaction_launch(const void* x, void* out, int64_t b, int f, int d,
                                      int spb, int stages, int threads, int64_t smem, int tile,
                                      void* stream) {
  if (b <= 0 || f <= 1 || d <= 0 || spb <= 0 || threads <= 0 || threads > 256 ||
      threads % 32 != 0 || (tile != 2 && tile != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(f, d, spb, tile);
  if (smem != static_cast<int64_t>(L.bytes(stages)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int which = 10 * stages + tile;
  cudaError_t err = which == 34   ? launch<3, 4>(xp, op, b, L, threads, smem, st)
                    : which == 24 ? launch<2, 4>(xp, op, b, L, threads, smem, st)
                    : which == 32 ? launch<3, 2>(xp, op, b, L, threads, smem, st)
                    : which == 22 ? launch<2, 2>(xp, op, b, L, threads, smem, st)
                                  : cudaErrorInvalidValue;
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
