// cat_decay: the epoch governor's CAR EMA on Hopper.
//
// Replaces the Pallas kernel repro/kernels/cat_decay.py::cat_decay (one
// grid step per page).  For every page v:
//
//   ema'[v] = f32(decay) * ema[v] + f32(1 - decay) * popcount(cat[v]) / max(alloc[v], 1)
//
// cat [V, P] is read as bool bytes (0/1) directly: the same values as the
// JAX package's int32 cast, with 4x fewer bytes.  The f32 operation order
// is that of the Pallas kernel and of ref.cat_decay_ref: an exact count,
// denom = f32(max(alloc, 1)), car = cnt / denom with an IEEE division, then
// the two products and the sum, each rounded on its own (__fmul_rn /
// __fadd_rn keep nvcc from contracting them into an FMA, which would round
// differently exactly where `ema >= thr` decides a PSF flip).  Both
// constants come rounded from the host, 1 - decay computed in double.
//
// Bound: bytes, V*P + 12*V (cat once, ema, alloc and the output 4 B each):
// 63 MB for a 3,145,728-page plane with P = 8, about 19 us at 3.35 TB/s.
// One thread per page; with P % 8 == 0 a page's cards are one or more
// 8-byte words whose popcount is the count of set cards, so a warp's loads
// are 256 contiguous bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
cat_decay_kernel(const uint8_t* __restrict__ cat,
                 const float* __restrict__ ema,
                 const int32_t* __restrict__ alloc, float* __restrict__ out,
                 int64_t n_pages, int page_objs, float decay, float keep) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_pages; v += stride) {
    const uint8_t* row = cat + v * page_objs;
    int cnt = 0;
    if (kWords) {
      const unsigned long long* w =
          reinterpret_cast<const unsigned long long*>(row);
      for (int k = 0; k < page_objs / 8; ++k) cnt += __popcll(__ldg(w + k));
    } else {
      for (int p = 0; p < page_objs; ++p) cnt += __ldg(row + p) != 0;
    }
    const int a = __ldg(alloc + v);
    const float denom = (float)(a > 1 ? a : 1);
    const float car = __fdiv_rn((float)cnt, denom);
    out[v] = __fadd_rn(__fmul_rn(decay, __ldg(ema + v)), __fmul_rn(keep, car));
  }
}

}  // namespace

extern "C" int repro_cat_decay(int device, const void* cat, const void* ema,
                               const void* alloc, void* out, int64_t n_pages,
                               int page_objs, float decay, float keep,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (n_pages + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool words = page_objs % 8 == 0 && ((uintptr_t)cat % 8) == 0;
  const uint8_t* c = static_cast<const uint8_t*>(cat);
  const float* m = static_cast<const float*>(ema);
  const int32_t* al = static_cast<const int32_t*>(alloc);
  float* o = static_cast<float*>(out);
  if (words) {
    cat_decay_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        c, m, al, o, n_pages, page_objs, decay, keep);
  } else {
    cat_decay_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        c, m, al, o, n_pages, page_objs, decay, keep);
  }
  return (int)cudaGetLastError();
}
