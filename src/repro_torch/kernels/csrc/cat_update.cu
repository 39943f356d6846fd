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
// Bound: bytes.  The words are read once and written once, the CAR is
// written once and the touches read once: 8*V*W + 4*V + 4*R bytes, 37.7 MB
// for the hybrid plane's CAT (V = 3,145,728, P = 8, W = 1) with R = 1024,
// 11.3 us at 3.35 TB/s.
//
// Design: one launch that moves those bytes and no more.  Each block of
// 512 threads owns a chunk of whole pages whose words fill 32 KB of shared
// memory (8,192 pages at W = 1, 4,096 at W = 2; a multiple of 4 pages, so
// every chunk starts on 16 bytes), beside a 32 KB delta of the same words.
//  1. One thread stages the chunk's words with one bulk copy (TMA,
//     cp.async.bulk, completing on an mbarrier); words a bulk copy cannot
//     take (a ragged last chunk, a chunk not on 16 bytes) are loaded by
//     plain loads.  The other threads clear the delta.
//  2. Meanwhile the block's threads stride over the touch list, four
//     16-byte loads in flight a thread: the same 4*R bytes for every
//     block, so L2 serves them after the first block (grid * 4*R bytes of
//     L2 reads: 1.6 MB at R = 1024 over 384 blocks).  A touch is the
//     block's when its vaddr lies in the chunk's range (one subtraction and
//     one unsigned compare, no division); its bit goes into the delta with
//     a shared-memory atomicOr: duplicates OR together, no global atomics.
//  3. Once the copy has landed, the block writes words | delta back with
//     16-byte stores, then one CAR a page (the popcount of its words, an
//     IEEE division as the plain version divides).
//
// Long touch lists: every block reads the whole list from L2, grid * 4*R
// bytes (100 MB at R = 65,536 over 384 blocks), so the time grows with
// grid * R.  At R = 65,536 the kernel is within 3% of the three-step design
// it replaced (a copy of the words, a scatter of global atomics, a count
// kernel: tools/cat_update_variants.py times both), and it falls clearly
// behind only at R = 262,144, far past any touch list the planes make, so
// there is one path.
//
// The count: with fewer than 32 words a page (the planes' CATs) one thread
// counts a page; wider pages are counted by the block's warps together
// (each warp sums every few runs of 32 of a page's words, a warp
// reduction, then one shared-memory add a warp).
//
// Pages wider than a chunk (W > 8,192, page_objs > 262,144) are split over
// ceil(W / 8,192) blocks, each one slice of 8,192 words of one page: it
// stages, updates and writes its slice as above (the same range test over
// the slice's objects) and counts it; the page's counts meet in a 64-bit
// counter a page (`acc`, zeroed by the caller) through one atomicAdd of
// (1 << 40) | count a block.  The block whose returned value holds the
// other blocks' tickets is the last: that value holds their counts too, so
// it writes the CAR.  No fence is needed, as nothing but that value passes
// between the blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = 8192;   // 32 KB of words a block
constexpr int kLoads = 4;           // 16-byte touch loads in flight a thread
constexpr int kSmemBytes = 2 * kChunkWords * 4;   // the words and their delta

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the barrier's one arrival, expecting `bytes` of copies to complete
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
// `bytes` (a multiple of 16) from global to shared memory, completing on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One block a chunk: `chunk_pages` whole pages (kSplit false, parts 1), or
// one of the `parts` slices of kChunkWords words of one page (kSplit).
// kWarpCount: the block's warps count a page (pages of 32 words or more);
// else one thread counts a page.  Pages of fewer than 32 words (the
// planes' CATs) take the instantiation with neither, the code they ran
// before pages could be split: compiled together with the warps' count,
// the touch scan ran slower on long touch lists.  `vec`: bits_in
// and bits_out lie on 16 bytes, so a chunk that starts on 16 bytes is
// staged by a bulk copy and written by 16-byte stores (a chunk of whole
// pages of fewer than 32 words always does).  `vec_touch`: vaddrs lie on
// 16 bytes (read 4 at a time).
template <bool kSplit, bool kWarpCount>
__global__ void __launch_bounds__(kThreads)
cat_update_kernel(const uint32_t* __restrict__ bits_in,
                  const int32_t* __restrict__ vaddrs, int64_t n_touch,
                  uint32_t* __restrict__ bits_out, float* __restrict__ car,
                  unsigned long long* __restrict__ acc, int64_t n_pages,
                  int words, int page_objs, int chunk_pages, int parts,
                  bool vec, bool vec_touch) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* words_s = smem;                  // the chunk's words
  uint32_t* delta_s = smem + kChunkWords;    // the bits the touches set
  __shared__ alignas(8) uint64_t bar_s;
  __shared__ int cnt_s[kChunkWords / 32];    // counts of the warps' sums
  const int tid = threadIdx.x;
  // the chunk: pages [p0, p0 + np) and words [w0, w0 + nw) of the CAT,
  // objects [lo64, hi64), pw words a page in it (a split page's: its slice)
  int64_t p0, w0, lo64, hi64;
  int np, nw, pw;
  if (kSplit) {
    p0 = blockIdx.x / parts;
    const int ws = (int)(blockIdx.x % parts) * kChunkWords;
    np = 1;
    nw = pw = min(kChunkWords, words - ws);
    w0 = p0 * words + ws;
    lo64 = p0 * page_objs + (int64_t)ws * 32;
    hi64 = min(lo64 + (int64_t)nw * 32, (p0 + 1) * page_objs);
  } else {
    p0 = (int64_t)blockIdx.x * chunk_pages;
    np = (int)min((int64_t)chunk_pages, n_pages - p0);
    nw = np * words;
    pw = words;
    w0 = p0 * words;
    lo64 = p0 * page_objs;
    hi64 = (p0 + np) * page_objs;
  }
  // 16-byte groups of words
  const int nw4 = vec && (!kWarpCount || (w0 & 3) == 0) ? nw / 4 : 0;
  const uint32_t bar = smem_u32(&bar_s);

  // 1. stage: the bulk copy first, then the words it leaves to plain
  // loads; the delta and the counts cleared meanwhile
  if (tid == 0) {
    mbar_init(bar);
    mbar_expect(bar, (uint32_t)nw4 * 16);
    if (nw4 > 0)
      bulk_load(smem_u32(words_s), bits_in + w0, (uint32_t)nw4 * 16, bar);
  }
  for (int i = 4 * nw4 + tid; i < nw; i += kThreads)
    words_s[i] = bits_in[w0 + i];
  uint4* d4 = reinterpret_cast<uint4*>(delta_s);
  for (int i = tid; i < (nw + 3) / 4; i += kThreads)
    d4[i] = make_uint4(0, 0, 0, 0);
  if (kWarpCount)
    for (int i = tid; i < np; i += kThreads) cnt_s[i] = 0;
  __syncthreads();

  // 2. the chunk's touches: vaddrs in [lo, lo + span), cut at 2^31 (no
  // int32 vaddr lies beyond; span is 0 for a chunk wholly past it).  A
  // negative vaddr is >= 2^31 as unsigned, so its offset is >= span.  A
  // split page's slice starts on a word: an offset is its bit there.
  hi64 = min(hi64, (int64_t)INT32_MAX + 1);
  const uint32_t lo = (uint32_t)min(lo64, hi64);
  const uint32_t span = (uint32_t)max(hi64 - lo64, (int64_t)0);
  auto take = [&](int32_t va) {
    const uint32_t off = (uint32_t)va - lo;
    if (off < span) {
      if (kSplit) {
        atomicOr(&delta_s[off >> 5], 1u << (off & 31));
      } else {
        const uint32_t page = off / (uint32_t)page_objs;
        const uint32_t slot = off - page * (uint32_t)page_objs;
        atomicOr(&delta_s[page * words + (slot >> 5)], 1u << (slot & 31));
      }
    }
  };
  // kLoads independent loads in flight a thread before any is tested
  int64_t done = 0;
  if (vec_touch) {
    const int4* v4 = reinterpret_cast<const int4*>(vaddrs);
    const int64_t n4 = n_touch / 4;
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
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n_touch; i += kThreads)
    take(__ldg(vaddrs + i));
  mbar_wait(bar, 0);
  __syncthreads();

  // 3. words | delta, back to shared memory and out; then the CAR
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
  const float fp = (float)page_objs;
  if (!kWarpCount) {
    for (int p = tid; p < np; p += kThreads) {
      int cnt = 0;
      for (int w = 0; w < words; ++w) cnt += __popc(words_s[p * words + w]);
      car[p0 + p] = __fdiv_rn((float)cnt, fp);
    }
    return;
  }
  // the warps share the pages (np <= 256): wpp warps a page when there
  // are fewer pages than warps, each summing every wpp-th run of 32 words
  const int warp = tid >> 5, lane = tid & 31;
  const int wpp = max(1, kWarps / np);
  for (int item = warp; item < np * wpp; item += kWarps) {
    const int p = item / wpp;
    const uint32_t* pws = words_s + p * pw;
    int cnt = 0;
    for (int w = (item - p * wpp) * 32 + lane; w < pw; w += 32 * wpp)
      cnt += __popc(pws[w]);
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) atomicAdd(&cnt_s[p], cnt);
  }
  __syncthreads();
  if (!kSplit) {
    for (int p = tid; p < np; p += kThreads)
      car[p0 + p] = __fdiv_rn((float)cnt_s[p], fp);
  } else if (tid == 0) {
    const unsigned long long mine = (unsigned long long)cnt_s[0];
    const unsigned long long old = atomicAdd(acc + p0, (1ull << 40) | mine);
    if ((long long)(old >> 40) == parts - 1) {
      const long long total = (long long)((old & ((1ull << 40) - 1)) + mine);
      car[p0] = __fdiv_rn((float)total, fp);
    }
  }
}

bool on16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int repro_cat_update(int device, const void* bits_in,
                                const void* vaddrs, void* bits_out, void* car,
                                void* acc, int64_t n_pages, int words,
                                int64_t n_touch, int page_objs,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int parts = (int)((words + (int64_t)kChunkWords - 1) / kChunkWords);
  if (page_objs < 1 || words < 1 || (parts > 1 && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = parts > 1     ? cat_update_kernel<true, true>
                : words >= 32 ? cat_update_kernel<false, true>
                              : cat_update_kernel<false, false>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int chunk_pages = 1;
  if (parts == 1) {
    chunk_pages = kChunkWords / words;
    if (chunk_pages >= 4) chunk_pages &= ~3;
  }
  const int64_t grid = parts > 1 ? n_pages * parts
                                 : (n_pages + chunk_pages - 1) / chunk_pages;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, kSmemBytes, s>>>(
      static_cast<const uint32_t*>(bits_in),
      static_cast<const int32_t*>(vaddrs), n_touch,
      static_cast<uint32_t*>(bits_out), static_cast<float*>(car),
      static_cast<unsigned long long*>(acc), n_pages, words, page_objs,
      chunk_pages, parts, on16(bits_in) && on16(bits_out), on16(vaddrs));
  return (int)cudaGetLastError();
}
