// cat_update: the card-access-table update on Hopper.
//
// Replaces the Pallas kernel repro/kernels/cat_update.py::cat_update (grid
// over pages; every grid step scans the whole scalar-prefetched touch list
// for the touches on its page, O(V*R) work).  Computes
//
//   bits' = bits | OR over touches of (1 << (slot % 32)) at word slot / 32
//   car[v] = popcount(bits'[v]) / page_objs
//
// for cat_bits [V, W] 32-bit words (int32 with the uint32 bits of the JAX
// version) and vaddrs [R] int32 (negative = skip; past the last page =
// dropped, as the JAX scatter drops it).
//
// Bound: bytes.  The words are read once and written once and the CAR is
// written once, 8*V*W + 4*V + 4*R bytes: 37.7 MB for the hybrid plane's
// CAT (V = 3,145,728, P = 8, W = 1) with R = 1024, 11.3 us at 3.35 TB/s.
// Design: three steps on the stream, each O(V) or O(R), none O(V*R): a
// device copy of the words, one thread per touch setting its bit with
// atomicOr (duplicate touches OR together in any order), and one thread
// per page counting its words' bits (__popc) into the CAR with an IEEE
// division, as the plain version divides.  The copy and the count read
// the words twice, 12.6 MB more than the bound counts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cat_scatter_kernel(const int32_t* __restrict__ vaddrs, int64_t n_touch,
                   uint32_t* __restrict__ bits, int64_t n_pages, int words,
                   int page_objs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_touch) return;
  const int32_t va = vaddrs[i];
  if (va < 0) return;
  const int64_t v = va / page_objs;
  if (v >= n_pages) return;
  const int slot = va % page_objs;
  atomicOr(bits + v * words + slot / 32, 1u << (slot % 32));
}

__global__ void __launch_bounds__(kThreads)
cat_count_kernel(const uint32_t* __restrict__ bits, float* __restrict__ car,
                 int64_t n_pages, int words, float page_objs) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_pages) return;
  int cnt = 0;
  for (int w = 0; w < words; ++w) cnt += __popc(bits[v * words + w]);
  car[v] = __fdiv_rn((float)cnt, page_objs);
}

}  // namespace

extern "C" int repro_cat_update(int device, const void* bits_in,
                                const void* vaddrs, void* bits_out, void* car,
                                int64_t n_pages, int words, int64_t n_touch,
                                int page_objs, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (page_objs < 1 || words < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemcpyAsync(bits_out, bits_in, (size_t)(n_pages * words) * 4,
                      cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  uint32_t* b = static_cast<uint32_t*>(bits_out);
  if (n_touch > 0) {
    cat_scatter_kernel<<<(unsigned)((n_touch + kThreads - 1) / kThreads),
                         kThreads, 0, s>>>(static_cast<const int32_t*>(vaddrs),
                                           n_touch, b, n_pages, words,
                                           page_objs);
  }
  cat_count_kernel<<<(unsigned)((n_pages + kThreads - 1) / kThreads),
                     kThreads, 0, s>>>(
      b, static_cast<float*>(car), n_pages, words, (float)page_objs);
  return (int)cudaGetLastError();
}
