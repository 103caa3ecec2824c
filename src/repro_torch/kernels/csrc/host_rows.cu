// Row gather and scatter for a table the card reaches over the bus, and the
// pinned host memory such tables live in (``--pin-l2``).
//
// Replaces no TPU kernel. The reference keeps its L2 tier and narrow
// masters in pinned host memory as XLA arrays and indexes them with XLA's
// own gathers and scatters; the port indexes device tables with torch, which
// cannot index a CPU tensor from the card. This kernel does that step for a
// table in pinned host memory mapped into the device address space:
//   gather  (scatter == 0): dst[i, :] = table[idx[i], :]   (dst on the card)
//   scatter (scatter == 1): table[idx[i], :] = src[i, :]
// for i < n, rows of `width` 4-byte words (float32 or int32). An index
// outside [0, rows) is skipped by the scatter and gives a zero row in the
// gather (the callers clamp their indices first, as torch indexing needs).
//
// Bound: bytes over the bus. Each row crosses PCIe once; a thread moves one
// 16-byte vector (or one word where the rows are not 16-byte aligned), so
// the 32 lanes of a warp ask for consecutive addresses of one row and the
// bus sees whole 128-byte requests on the wide tables. The scatter writes
// with plain stores only: atomics on host memory are not guaranteed over
// PCIe.
//
// The allocator gives an exact-size, page-locked, mapped buffer
// (cudaHostAlloc), where torch's caching host allocator would round the
// block up to a power of two (a 22.4 GiB master would take 32 GiB), and
// returns its device address from cudaHostGetDevicePointer: the kernels get
// that address, not the host one.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const T* __restrict__ src, const int64_t* __restrict__ idx, T* __restrict__ dst,
                int64_t n, int64_t rows, int64_t width, bool scatter) {
  const int64_t total = n * width;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / width, c = e - i * width;
    const int64_t r = idx[i];
    const bool ok = r >= 0 && r < rows;
    if (scatter) {
      if (ok) dst[r * width + c] = src[e];
    } else {
      T v{};
      if (ok) v = src[r * width + c];
      dst[e] = v;
    }
  }
}

}  // namespace

// `table` [rows, width words] (pinned host memory by its device address, or
// device memory), `rows_dev` [n, width] on the card, `idx` [n] int64 on the
// card. Gathers table rows into rows_dev, or scatters rows_dev into the
// table, on `stream`. Returns the first CUDA error so the caller can raise.
extern "C" int host_rows_launch(void* table, const void* idx, void* rows_dev, int64_t n,
                                int64_t rows, int width, int scatter, void* stream) {
  if (n < 0 || rows < 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int64_t*>(idx);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows_dev) % 16 == 0;
  const int64_t w = vec ? width / 4 : width;
  const int64_t blocks_needed = (n * w + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(blocks_needed < 65535 * 8 ? blocks_needed
                                                                          : 65535 * 8);
  if (vec) {
    auto* t = static_cast<int4*>(table);
    auto* r = static_cast<int4*>(rows_dev);
    if (scatter)
      rows_kernel<int4><<<blocks, kThreads, 0, st>>>(r, ip, t, n, rows, w, true);
    else
      rows_kernel<int4><<<blocks, kThreads, 0, st>>>(t, ip, r, n, rows, w, false);
  } else {
    auto* t = static_cast<int32_t*>(table);
    auto* r = static_cast<int32_t*>(rows_dev);
    if (scatter)
      rows_kernel<int32_t><<<blocks, kThreads, 0, st>>>(r, ip, t, n, rows, w, true);
    else
      rows_kernel<int32_t><<<blocks, kThreads, 0, st>>>(t, ip, r, n, rows, w, false);
  }
  return static_cast<int>(cudaGetLastError());
}

// `bytes` of page-locked host memory mapped into the device address space:
// `*host` its host address, `*dev` the address kernels use. Returns the
// first CUDA error (nothing is left allocated on an error).
extern "C" int host_rows_alloc(uint64_t bytes, void** host, void** dev) {
  *host = nullptr;
  *dev = nullptr;
  cudaError_t err = cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(dev, *host, 0);
  if (err != cudaSuccess || *dev == nullptr) {
    cudaFreeHost(*host);
    *host = nullptr;
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" int host_rows_free(void* host) { return static_cast<int>(cudaFreeHost(host)); }

// The CUDA driver's account of `ptr`: `*kind` its cudaMemoryType (1 = page-locked
// host memory) and `*dev` the device address of that byte (null where none).
extern "C" int host_rows_pointer_kind(const void* ptr, int* kind, void** dev) {
  cudaPointerAttributes attr{};
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  *kind = err == cudaSuccess ? static_cast<int>(attr.type) : 0;
  *dev = err == cudaSuccess ? attr.devicePointer : nullptr;
  return static_cast<int>(err);
}
