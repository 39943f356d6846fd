// Designs of the CAT update that tools/cat_update_variants.py times beside
// the port's kernel (src/repro_torch/kernels/csrc/cat_update.cu).
//
// cuv_pipelined: the port's one-launch kernel made persistent.  A grid of
// `blocks_per_sm` blocks an SM walks the chunks (chunk c, c + grid, ...);
// each block keeps a ring of two chunk buffers and stages chunk c + grid
// by a bulk copy while it scans the touches of chunk c into its delta,
// ORs the delta in, writes the words back and counts the CAR, so that the
// card reads the next chunks while it writes the last ones.  Every chunk
// still scans the whole touch list (from L2).
//
// cuv_three_steps: the port's design before the one-launch kernel, kept to
// time against it on long touch lists: a device copy of the words, one
// thread a touch setting its bit with a global atomicOr, and one thread a
// page counting its words into the CAR.  It reads the words twice (4*V*W
// bytes above the bound) but the touch list once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLoads = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// chunk_words * 4 bytes a buffer; bits_in, bits_out on 16 bytes and
// chunk_pages a multiple of 4 (the caller checks)
__global__ void __launch_bounds__(kThreads)
pipelined_kernel(const uint32_t* __restrict__ bits_in,
                 const int4* __restrict__ v4, int64_t n4,
                 uint32_t* __restrict__ bits_out, float* __restrict__ car,
                 int64_t n_pages, int words, int page_objs, int chunk_pages,
                 int64_t n_chunks) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int chunk_words = chunk_pages * words;
  uint32_t* delta_s = smem + 2 * chunk_words;
  __shared__ alignas(8) uint64_t bar_s[2];
  __shared__ float quot_s[1025];
  const int tid = threadIdx.x;
  const float fp = (float)page_objs;
  const bool table = 32 * words < 1025;
  auto stage = [&](int64_t c, int buf) {
    const int64_t p0 = c * chunk_pages;
    const int np = (int)min((int64_t)chunk_pages, n_pages - p0);
    const int nw4 = np * words / 4;
    const uint32_t bar = smem_u32(&bar_s[buf]);
    mbar_expect(bar, (uint32_t)nw4 * 16);
    if (nw4 > 0)
      bulk_load(smem_u32(smem + buf * chunk_words), bits_in + p0 * words,
                (uint32_t)nw4 * 16, bar);
  };
  if (tid == 0) {
    mbar_init(smem_u32(&bar_s[0]));
    mbar_init(smem_u32(&bar_s[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x < n_chunks) stage(blockIdx.x, 0);
  }
  if (table)
    for (int c = tid; c <= 32 * words; c += kThreads)
      quot_s[c] = __fdiv_rn((float)c, fp);
  int it = 0;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
    const int buf = it & 1;
    uint32_t* words_s = smem + buf * chunk_words;
    const int64_t p0 = c * chunk_pages;
    const int np = (int)min((int64_t)chunk_pages, n_pages - p0);
    const int nw = np * words;
    const int nw4 = nw / 4;
    const int64_t w0 = p0 * words;
    // the next chunk into the other buffer, which the last iteration
    // finished reading before its closing barrier
    if (tid == 0 && c + gridDim.x < n_chunks) stage(c + gridDim.x, buf ^ 1);
    for (int i = 4 * nw4 + tid; i < nw; i += kThreads)
      words_s[i] = bits_in[w0 + i];
    uint4* d4 = reinterpret_cast<uint4*>(delta_s);
    for (int i = tid; i < (nw + 3) / 4; i += kThreads)
      d4[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int64_t lo64 = p0 * page_objs;
    const int64_t hi64 = min((p0 + np) * page_objs, (int64_t)INT32_MAX + 1);
    const uint32_t lo = (uint32_t)min(lo64, hi64);
    const uint32_t span = (uint32_t)max(hi64 - lo64, (int64_t)0);
    auto take = [&](int32_t va) {
      const uint32_t off = (uint32_t)va - lo;
      if (off < span) {
        const uint32_t page = off / (uint32_t)page_objs;
        const uint32_t slot = off - page * (uint32_t)page_objs;
        atomicOr(&delta_s[page * words + (slot >> 5)], 1u << (slot & 31));
      }
    };
    for (int64_t i0 = tid; i0 < n4; i0 += (int64_t)kThreads * kLoads) {
      int4 t[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int64_t i = i0 + (int64_t)u * kThreads;
        t[u] = i < n4 ? __ldg(v4 + i) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        take(t[u].x);
        take(t[u].y);
        take(t[u].z);
        take(t[u].w);
      }
    }
    mbar_wait(smem_u32(&bar_s[buf]), (it >> 1) & 1);
    __syncthreads();
    uint32_t* out = bits_out + w0;
    uint4* s4 = reinterpret_cast<uint4*>(words_s);
    for (int i = tid; i < nw4; i += kThreads) {
      uint4 w = s4[i];
      const uint4 d = d4[i];
      w.x |= d.x;
      w.y |= d.y;
      w.z |= d.z;
      w.w |= d.w;
      s4[i] = w;
      reinterpret_cast<uint4*>(out)[i] = w;
    }
    for (int i = 4 * nw4 + tid; i < nw; i += kThreads) {
      words_s[i] |= delta_s[i];
      out[i] = words_s[i];
    }
    __syncthreads();
    for (int p = tid; p < np; p += kThreads) {
      int cnt = 0;
      for (int w = 0; w < words; ++w) cnt += __popc(words_s[p * words + w]);
      car[p0 + p] = table ? quot_s[cnt] : __fdiv_rn((float)cnt, fp);
    }
    // this buffer's generic writes before a later bulk copy overwrites it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256)
scatter_kernel(const int32_t* __restrict__ vaddrs, int64_t n_touch,
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

__global__ void __launch_bounds__(256)
count_kernel(const uint32_t* __restrict__ bits, float* __restrict__ car,
             int64_t n_pages, int words, float page_objs) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_pages) return;
  int cnt = 0;
  for (int w = 0; w < words; ++w) cnt += __popc(bits[v * words + w]);
  car[v] = __fdiv_rn((float)cnt, page_objs);
}

}  // namespace

extern "C" int cuv_three_steps(const void* bits_in, const void* vaddrs,
                               void* bits_out, void* car, int64_t n_pages,
                               int words, int64_t n_touch, int page_objs,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(bits_out, bits_in,
                                  (size_t)(n_pages * words) * 4,
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  uint32_t* b = static_cast<uint32_t*>(bits_out);
  if (n_touch > 0)
    scatter_kernel<<<(unsigned)((n_touch + 255) / 256), 256, 0, s>>>(
        static_cast<const int32_t*>(vaddrs), n_touch, b, n_pages, words,
        page_objs);
  count_kernel<<<(unsigned)((n_pages + 255) / 256), 256, 0, s>>>(
      b, static_cast<float*>(car), n_pages, words, (float)page_objs);
  return (int)cudaGetLastError();
}

// vaddrs on 16 bytes and a multiple of 4 long (the caller checks)
extern "C" int cuv_pipelined(const void* bits_in, const void* vaddrs,
                             void* bits_out, void* car, int64_t n_pages,
                             int words, int64_t n_touch, int page_objs,
                             int chunk_words, int blocks_per_sm,
                             void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int chunk_pages = (chunk_words / words) & ~3;
  const int smem = 3 * chunk_pages * words * 4;
  cudaError_t e = cudaFuncSetAttribute(
      pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_chunks = (n_pages + chunk_pages - 1) / chunk_pages;
  const int64_t grid = n_chunks < (int64_t)sms * blocks_per_sm
                           ? n_chunks : (int64_t)sms * blocks_per_sm;
  pipelined_kernel<<<(unsigned)grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits_in),
      static_cast<const int4*>(vaddrs), n_touch / 4,
      static_cast<uint32_t*>(bits_out), static_cast<float*>(car), n_pages,
      words, page_objs, chunk_pages, n_chunks);
  return (int)cudaGetLastError();
}
