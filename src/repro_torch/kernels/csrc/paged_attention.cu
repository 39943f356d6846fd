// paged_attention: GQA decode attention through the KV plane's page table,
// on Hopper.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py::
// paged_attention.  There the grid is (B, KVH, NP) with the page axis
// innermost and run in order, so the online-softmax state (m, l, acc)
// carries across pages in VMEM scratch, and the page-table entries are
// scalar-prefetched (clamped at 0) to drive each page's DMA.  Here a block
// owns one (sequence, kv head) and a contiguous range of pages, loops over
// them itself, and loads its own page-table entries.
//
//   q [B, KVH, G, Dh], k/v_pages [KVH, F, P, Dh], page_table/page_lens
//   [B, NP] int32  ->  out [B, KVH, G, Dh] (q's dtype),
//   used [B, NP, P] (one byte per row, OR over kv heads and query heads)
//
// A column is attended when its frame is >= 0 and its row count > 0; its
// first page_lens rows are valid.  Scores are q.k / sqrt(Dh) in f32, the
// softmax is online in f32, and a sequence with no valid row gives 0 (the
// sum is clamped at 1e-30, as in the Pallas kernel).  `used` marks a row
// whose weight exceeds its page's mean, p*P > sum_page p, for any query
// head; the kernel sums p in its own order, so a row within rounding of
// that threshold may differ from the plain version.
//
// Bound: bytes.  Each valid row of K and V is read once, 2*rows*Dh*itemsize
// bytes: 17.2 GB for llama3-8b's decode_32k plane (B 128, KVH 8, 32,768
// tokens each, bf16), 5.13 ms at 3.35 TB/s; 16.8 MB for a long_500k sparse
// step (64 selected pages), 5.0 us.  The arithmetic, 4*G*Dh operations per
// row, stays far below the card's rate at G = 4.
//
// Two paths, chosen by the wrapper from dtype and shape (never on an
// error):
//
// The tensor-core path (bf16 q with bf16 K/V, Dh a multiple of 16 up to
// 256, P up to 64, G up to 64: every configuration of the repo).  The
// CUDA-core kernel below runs the dense decode_32k step at about a third
// of the byte bound on an H100, bound by instruction issue (2-3 CUDA-core
// instructions per multiply-add, four block barriers a page), not by
// memory.  Here both products run on mma.sync.m16n8k16 (bf16 in, f32
// accumulate):
//   * A block owns one (sequence, kv head) and a range of pages, and
//     holds `teams` teams of m_tiles warps.  The G query heads are padded
//     to 16-row m-tiles, one warp per m-tile; a team walks the pages
//     team, team + teams, ... of the range, so each page is staged once
//     in shared memory and read by the team's m_tiles warps.  Unsplit
//     (the pairs fill the card) a block is one team, 53 KB at Dh 128, so
//     four blocks share an SM; split, four teams a block.
//   * Each team has its own ring of 3 slots in shared memory (K and V of
//     a page take one each), filled by the TMA: one thread arms the slot's
//     mbarrier and issues Dh/64 box copies of [P16 rows, 64 columns] from
//     a tensor map over the pages, with the TMA's 128-byte swizzle (a
//     256-byte row read unswizzled by ldmatrix is 8-way bank conflicted).
//     While the team computes on one slot the other two are in flight: 32
//     KB a team at Dh 128, 128 KB an SM.  Copying 16 bytes a lane with
//     cp.async instead keeps the load/store pipe so busy that each page's
//     ldmatrix reads wait behind the copies (PERF.md).  Columns past Dh come
//     zero-filled; rows past page_lens hold whatever the pool holds there
//     and are masked to -1e30 in S (K) or zeroed in the slot before P V
//     (V: p = 0 there, and 0 x NaN is NaN).  Two team-scoped named
//     barriers a page, no block barrier.  Q comes by cp.async, once.
//   * S = Q K^T: Q and K by ldmatrix, the f32 product scaled after the
//     product (q is not rounded again), by log2(e)/sqrt(Dh): the online
//     softmax runs in base 2 (exp2f), which is exp(q.k/sqrt(Dh) - m) up
//     to f32 rounding.  A quad of lanes shares a head row, so row max and
//     row sum are two shuffles; each warp keeps its own (m, l, acc), acc
//     a 16 x Dh f32 fragment.  `used` comes from the f32 p: mass per head
//     by the quad sums, OR over heads by shuffles, OR over kv heads by
//     byte stores of 1.
//   * acc += P V: the S accumulators become the A operand directly (the
//     FlashAttention-2 register layout; p rounded to bf16 here, l stays
//     the sum of the f32 p); V by ldmatrix.trans.
//   * The teams' partials combine once, in team order, in shared memory;
//     with the pages split over blocks (flash-decoding, few pairs) the
//     last block of a pair to finish (__threadfence + atomicAdd on a
//     per-pair counter, which it resets to 0) stages the splits' partials
//     by cp.async and combines them in split order, in the same kernel.
//     No float atomics: the result is the same bits from run to run.
//
// The CUDA-core path (f32 or mixed inputs, where TF32 would miss the f32
// tolerance; Dh a multiple of 8 but not of 16; P 65-128), G up to 8.  Per
// page: (1) each row's G dot products, a group of lanes per
// row (8 elements per lane, shuffle-reduced), into shared memory; (2) one
// warp per query head updates m and l, turns the scores into p and marks
// the used rows; (3) each thread accumulates 8 output dims for all G
// heads over a strided subset of rows, its partial sums kept in registers
// across pages.  Row groups are reduced in a fixed order at the end, so
// the result is the same from run to run.  The staged variant copies the
// NEXT page's K and V rows into shared memory with cp.async (two
// buffers) while it computes on this one.  Pages whose two buffers do not
// fit (4 * P * Dh * itemsize > 128 KB) take the unstaged variant, which
// reads K and V straight from device memory.  With few (sequence, head)
// pairs the pages are split over blocks (flash-decoding) and a second
// kernel combines the partial (m, l, acc) in split order.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 128;
constexpr int kMaxDh = 256;
constexpr int kMaxSplit = 1024;
constexpr int64_t kMaxStageBytes = 128 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(x);
}

// 8 consecutive elements (16 bytes of bf16, 32 of f32) as f32, from
// device or shared memory
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename TQ, typename TKV, int kMaxG, bool kStaged>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ page_lens,
                       TQ* __restrict__ out, uint8_t* __restrict__ used,
                       float* __restrict__ m_part, float* __restrict__ l_part,
                       float* __restrict__ acc_part, int kv_heads, int group,
                       int head_dim, int64_t n_frames, int page_rows,
                       int n_pages, int n_split, int pages_per_split,
                       float scale) {
  __shared__ float q_s[kMaxG * kMaxDh];
  __shared__ float p_s[kMaxG * kMaxP];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ uint8_t used_s[kMaxP];
  // dynamic: the two K/V page buffers (staged), then the row-group
  // reduction [G, Dh] f32 over the same bytes after the page loop
  extern __shared__ __align__(16) unsigned char dyn_s[];
  float* red_s = reinterpret_cast<float*>(dyn_s);

  const int bh = blockIdx.x;                 // b * KVH + h
  const int split = blockIdx.y;
  const int b = bh / kv_heads, h = bh % kv_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = group, Dh = head_dim, P = page_rows;

  const TQ* qb = q + (int64_t)bh * G * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < kMaxP; i += kThreads) used_s[i] = 0;
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // scores: a group of `lpr` lanes per row, one 8-element chunk per lane
  const int n_chunks = Dh / 8;
  int lpr = 1;
  while (lpr < n_chunks) lpr <<= 1;
  const int rows_per_pass = 32 / lpr;
  const int sub = lane % lpr, grp = lane / lpr;
  // accumulation: thread -> (chunk c, row group rg)
  const int n_rg = kThreads / n_chunks;
  const int c = tid % n_chunks, rg = tid / n_chunks;
  const bool acc_thread = rg < n_rg;

  float acc[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  const int j0 = split * pages_per_split;
  const int j1 = min(n_pages, j0 + pages_per_split);
  const int64_t tile = (int64_t)P * Dh;        // elements of one page
  TKV* stage = reinterpret_cast<TKV*>(dyn_s);
  // staged: copy page j's valid K and V rows into buffer `buf` (one
  // commit group per call, empty when there is nothing to copy)
  auto issue = [&](int j, int buf) {
    if (j < j1) {
      const int64_t col = (int64_t)b * n_pages + j;
      const int frame = page_table[col];
      const int rows = min(page_lens[col], P);
      if (frame >= 0 && rows > 0) {
        const int64_t off = (((int64_t)h * n_frames + frame) * P) * Dh;
        const char* ks = reinterpret_cast<const char*>(k_pages + off);
        const char* vs = reinterpret_cast<const char*>(v_pages + off);
        char* kd = reinterpret_cast<char*>(stage + buf * 2 * tile);
        char* vd = reinterpret_cast<char*>(stage + buf * 2 * tile + tile);
        const int chunks = rows * Dh * (int)sizeof(TKV) / 16;
        for (int i = tid; i < chunks; i += kThreads) {
          __pipeline_memcpy_async(kd + 16 * i, ks + 16 * i, 16);
          __pipeline_memcpy_async(vd + 16 * i, vs + 16 * i, 16);
        }
      }
    }
    __pipeline_commit();
  };
  if (kStaged) issue(j0, 0);
  for (int j = j0; j < j1; ++j) {
    if (kStaged) {
      issue(j + 1, (j - j0 + 1) & 1);            // the next page, in flight
      __pipeline_wait_prior(1);                  // this page has landed
      __syncthreads();
    }
    const int64_t col = (int64_t)b * n_pages + j;
    const int frame = page_table[col];
    int rows = page_lens[col];
    if (frame < 0 || rows <= 0) continue;    // block-uniform
    if (rows > P) rows = P;
    const int64_t page_off = (((int64_t)h * n_frames + frame) * P) * Dh;
    const TKV* kp = kStaged ? stage + ((j - j0) & 1) * 2 * tile
                            : k_pages + page_off;
    const TKV* vp = kStaged ? kp + tile : v_pages + page_off;

    // (1) scores
    for (int r0 = warp * rows_per_pass; r0 < rows; r0 += kWarps * rows_per_pass) {
      const int r = r0 + grp;
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (r < rows && sub < n_chunks) {
        float kv[8];
        load8(kp + (int64_t)r * Dh + sub * 8, kv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float* qq = q_s + g * Dh + sub * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e) part[g] += qq[e] * kv[e];
          }
        }
      }
      for (int off = lpr / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      }
      if (sub == 0 && r < rows) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) p_s[g * kMaxP + r] = part[g] * scale;
      }
    }
    __syncthreads();

    // (2) online-softmax state and the card signal, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* ps = p_s + g * kMaxP;
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, ps[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(ps[r] - m_new);
        ps[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int r = lane; r < rows; r += 32)
        if (ps[r] * (float)P > sum) used_s[r] = 1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = alpha * acc + p . V
    if (acc_thread) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float al = g < G ? alpha_s[g] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= al;
      }
      for (int r = rg; r < rows; r += n_rg) {
        float vv[8];
        load8(vp + (int64_t)r * Dh + c * 8, vv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float p = p_s[g * kMaxP + r];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] += p * vv[e];
          }
        }
      }
    }
    for (int r = tid; r < rows; r += kThreads) {
      if (used_s[r]) {
        used[col * P + r] = 1;
        used_s[r] = 0;
      }
    }
    __syncthreads();
  }

  // the row groups' partial sums, reduced in a fixed order (red_s
  // overlays the page buffers, free once every copy has landed)
  if (kStaged) __pipeline_wait_prior(0);
  __syncthreads();
  for (int i = tid; i < G * Dh; i += kThreads) red_s[i] = 0.f;
  __syncthreads();
  for (int g2 = 0; g2 < n_rg; ++g2) {
    if (acc_thread && rg == g2) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) red_s[g * Dh + c * 8 + e] += acc[g][e];
        }
    }
    __syncthreads();
  }
  if (n_split == 1) {
    for (int i = tid; i < G * Dh; i += kThreads) {
      const float l = fmaxf(l_s[i / Dh], 1e-30f);
      from_f(red_s[i] / l, out + (int64_t)bh * G * Dh + i);
    }
  } else {
    const int64_t ps = (int64_t)bh * n_split + split;
    for (int i = tid; i < G * Dh; i += kThreads)
      acc_part[ps * G * Dh + i] = red_s[i];
    if (tid < G) {
      m_part[ps * G + tid] = m_s[tid];
      l_part[ps * G + tid] = l_s[tid];
    }
  }
}

// flash-decoding combine, one block per (sequence, kv head, query head):
// out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max m),
// every sum in split order
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
               const float* __restrict__ acc_part, TQ* __restrict__ out,
               int group, int head_dim, int n_split) {
  __shared__ float w_s[kMaxSplit];
  __shared__ float l_tot;
  const int bh = blockIdx.x, g = blockIdx.y;
  const int64_t base = (int64_t)bh * n_split;
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int s = threadIdx.x; s < n_split; s += 32)
      mx = fmaxf(mx, m_part[(base + s) * group + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int s = threadIdx.x; s < n_split; s += 32)
      w_s[s] = expf(m_part[(base + s) * group + g] - mx);
    __syncwarp();
    if (threadIdx.x == 0) {
      float l = 0.f;
      for (int s = 0; s < n_split; ++s)
        l += l_part[(base + s) * group + g] * w_s[s];
      l_tot = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  const int64_t GD = (int64_t)group * head_dim;
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    const float* a = acc_part + base * GD + g * head_dim + d;
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) acc += a[s * GD] * w_s[s];
    from_f(acc / l_tot, out + bh * GD + g * head_dim + d);
  }
}

template <typename TQ, typename TKV, int kMaxG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* pt, const int32_t* pl, void* out,
                   uint8_t* used, float* m_part, float* l_part,
                   float* acc_part, int64_t batch, int kv_heads, int group,
                   int head_dim, int64_t n_frames, int page_rows, int n_pages,
                   int n_split, int pages_per_split, float scale,
                   cudaStream_t s) {
  dim3 grid((unsigned)(batch * kv_heads), (unsigned)n_split);
  const int64_t stage = 4 * (int64_t)page_rows * head_dim * sizeof(TKV);
  const int64_t red = (int64_t)group * head_dim * sizeof(float);
  const bool staged = stage <= kMaxStageBytes;
  const size_t smem = (size_t)(staged && stage > red ? stage : red);
  auto kern = staged ? paged_attention_kernel<TQ, TKV, kMaxG, true>
                     : paged_attention_kernel<TQ, TKV, kMaxG, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), pt, pl, static_cast<TQ*>(out), used, m_part,
      l_part, acc_part, kv_heads, group, head_dim, n_frames, page_rows,
      n_pages, n_split, pages_per_split, scale);
  if (n_split > 1) {
    dim3 cgrid((unsigned)(batch * kv_heads), (unsigned)group);
    combine_kernel<TQ><<<cgrid, kThreads, 0, s>>>(
        m_part, l_part, acc_part, static_cast<TQ*>(out), group, head_dim,
        n_split);
  }
  return cudaSuccess;
}

template <typename TQ, typename TKV>
cudaError_t dispatch_group(int group, const void* q, const void* k, const void* v,
                   const int32_t* pt, const int32_t* pl, void* out,
                   uint8_t* used, float* m_part, float* l_part,
                   float* acc_part, int64_t batch, int kv_heads,
                   int head_dim, int64_t n_frames, int page_rows, int n_pages,
                   int n_split, int pages_per_split, float scale,
                   cudaStream_t s) {
  if (group <= 4) {
    return launch<TQ, TKV, 4>(q, k, v, pt, pl, out, used, m_part, l_part,
                              acc_part, batch, kv_heads, group, head_dim,
                              n_frames, page_rows, n_pages, n_split,
                              pages_per_split, scale, s);
  }
  return launch<TQ, TKV, 8>(q, k, v, pt, pl, out, used, m_part, l_part,
                            acc_part, batch, kv_heads, group, head_dim,
                            n_frames, page_rows, n_pages, n_split,
                            pages_per_split, scale, s);
}

// ---------------------------------------------------------------------------
// the tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;      // at most 8 warps: teams x m_tiles
constexpr int kRing = 3;              // ring slots per team
constexpr int kMmaMaxRows = 64;       // page rows the path takes
constexpr int kMmaMaxTiles = 4;       // G <= 64
constexpr int kMmaSmemLimit = 232448 - 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes and reads none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// mbarriers (CTA scope) and the tensor memory accelerator (TMA): one
// instruction copies a [P16, 64] bf16 box of a page, off the load/store
// pipe that ldmatrix uses
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
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
// the box at (column x, row y) of a 2-D tensor map into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier over the `n` threads of one team (named barrier `id` >= 1)
__device__ __forceinline__ void team_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t a, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}
// c += a * b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
// byte offset of 16-byte chunk c of row r in a tile of kDh-wide bf16 rows,
// the chunk index XORed with the row's low 3 bits (the Q tile)
template <int kDh>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (kDh * 2) + ((c ^ (r & 7)) << 4));
}
// the same for a K or V slot as the TMA writes it with 128-byte swizzling:
// 64-column boxes of p16 rows of 128 bytes, one after another, each 16-byte
// chunk XORed with the row's low 3 bits within its 128 bytes
__device__ __forceinline__ uint32_t tswz(int r, int c, int p16) {
  return (uint32_t)((c >> 3) * p16 * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Shared memory (dynamic): Q [16*m_tiles, kDh] bf16, then one ring of
// kRing slots of [P16, kDh] bf16 per team.  After the page loop the same
// bytes hold the teams' partials, then the split weights.  kDh is Dh
// rounded up to 64, 128 or 256 (the extra columns are zero).
template <int kDh>
__global__ void __launch_bounds__(kMmaThreads)
paged_attention_mma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __nv_bfloat16* __restrict__ q,
                           const int32_t* __restrict__ page_table,
                           const int32_t* __restrict__ page_lens,
                           __nv_bfloat16* __restrict__ out,
                           uint8_t* __restrict__ used,
                           float* __restrict__ m_part,
                           float* __restrict__ l_part,
                           float* __restrict__ acc_part,
                           int* __restrict__ counters, int kv_heads,
                           int group, int head_dim, int64_t n_frames,
                           int page_rows, int n_pages, int n_split,
                           int pages_per_split, int m_tiles, int teams,
                           float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int last_s;
  __shared__ __align__(8) uint64_t full_s[kMmaThreads / 32][kRing];
  constexpr int kChunks = kDh / 8;   // 16-byte chunks of a row; n-tiles of acc
  constexpr int kKSteps = kDh / 16;  // k-steps of Q K^T
  constexpr int kSTiles = kMmaMaxRows / 8;   // n-tiles of S
  const int G = group, Dh = head_dim, P = page_rows;
  const int P16 = (P + 15) & ~15;
  const int rows_pad = 16 * m_tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int team = warp / m_tiles, mt = warp % m_tiles;
  const int team_threads = 32 * m_tiles, ttid = tid - team * team_threads;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row, column pair
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row, matrix
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / kv_heads, h = bh % kv_heads;
  const int item_bytes = P16 * kDh * 2;
  unsigned char* q_s = smem;
  // the rings start at the first 1024-byte boundary past Q (the TMA's
  // 128-byte swizzle repeats every 1024 bytes of shared memory)
  const uint32_t q_end = smem_u32(smem) + rows_pad * kDh * 2;
  unsigned char* ring0 = smem + rows_pad * kDh * 2 + ((1024 - (q_end & 1023)) & 1023);
  unsigned char* ring = ring0 + team * kRing * item_bytes;

  const int j0 = split * pages_per_split;
  const int j1 = min(n_pages, j0 + pages_per_split);
  const int n_mine = j1 - j0 > team ? (j1 - j0 - team + teams - 1) / teams
                                    : 0;
  const int64_t col0 = (int64_t)b * n_pages + j0 + team;
  // the page-table entry of the team's page p (frame -1 past its pages),
  // loaded a page ahead of its use
  auto entry = [&](int p, int& frame, int& rows) {
    frame = -1;
    rows = 0;
    if (p < n_mine) {
      const int64_t col = col0 + (int64_t)p * teams;
      frame = page_table[col];
      rows = min(page_lens[col], P);
    }
  };
  // item `it` of this team: K (even) or V (odd) of its page it / 2, whose
  // entry is (frame, rows), into ring slot it % kRing.  One thread of the
  // team arms the slot's barrier and issues the page's kDh / 64 boxes of
  // P16 rows (none when the page is not attended or the team has no more
  // pages).  Columns past Dh are zero-filled by the TMA; rows past
  // page_lens hold what memory holds there, and are masked in S (K) or
  // zeroed before P V (V).
  auto issue = [&](int it, int frame, int rows) {
    if (ttid != 0) return;
    const uint32_t bar = smem_u32(&full_s[team][it % kRing]);
    const bool live = frame >= 0 && rows > 0;
    mbar_expect(bar, live ? item_bytes : 0);
    if (live) {
      const CUtensorMap* map = (it & 1) ? &v_map : &k_map;
      const uint32_t dst = smem_u32(ring + (it % kRing) * item_bytes);
      const int y = (int)(((int64_t)h * n_frames + frame) * P);
#pragma unroll
      for (int x = 0; x < kDh / 64; ++x)
        tma_load(dst + x * P16 * 128, map, 64 * x, y, bar);
    }
  };
  // wait until item `it` has landed (the k-th use of a slot has parity k&1)
  auto landed = [&](int it) {
    mbar_wait(smem_u32(&full_s[team][it % kRing]), (it / kRing) & 1);
  };

  float acc[kChunks][4];
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads gq, gq + 8
  const bool hv0 = 16 * mt + gq < G, hv1 = 16 * mt + gq + 8 < G;
  const uint32_t q_base = smem_u32(q_s);
  const float fP = (float)P;
  const float scale2 = scale * 1.4426950408889634f;

  // the barriers, set up before any copy
  if (tid < teams * kRing) mbar_init(smem_u32(&full_s[tid / kRing][tid % kRing]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // Q, padded with zero rows (heads >= G) and columns (>= Dh), swizzled
  const __nv_bfloat16* qb = q + (int64_t)bh * G * Dh;
  for (int i = tid; i < rows_pad * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < G && c * 8 < Dh;
    cp_async16(smem_u32(q_s) + swz<kDh>(r, c), ok ? qb + r * Dh + c * 8 : qb,
               ok ? 16 : 0);
  }
  cp_commit();
  static_assert(kRing == 3, "the ring holds one page ahead: K and V");
  int frame, rows;                     // this page's entry
  entry(0, frame, rows);
  issue(0, frame, rows);
  issue(1, frame, rows);
  cp_wait<0>();                        // Q has landed
  __syncthreads();

  for (int p = 0; p < n_mine; ++p) {
    const int64_t col = col0 + (int64_t)p * teams;
    const bool live = frame >= 0 && rows > 0;           // team-uniform
    int next_frame, next_rows;
    entry(p + 1, next_frame, next_rows);
    const uint32_t k_s = smem_u32(ring + ((2 * p) % kRing) * item_bytes);
    const uint32_t v_s = smem_u32(ring + ((2 * p + 1) % kRing) * item_bytes);
    landed(2 * p);                     // K of this page
    team_sync(team + 1, team_threads); // and the last page's V slot is free
    issue(2 * p + 2, next_frame, next_rows);   // into the last page's V slot

    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (live) {
      // S = Q K^T over this warp's m-tile and the page's rows; up to Dh
      // 128 the fragments of k-step ks + 1 are loaded before the products
      // of ks (ldmatrix takes some hundreds of cycles; at Dh 256 the
      // second buffer would not fit in registers)
      constexpr int kSBuf = kDh <= 128 ? 2 : 1;
      uint32_t qa[kSBuf][4], kb[kSBuf][kSTiles / 2][4];
      auto load_s = [&](int ks, uint32_t (&a)[4], uint32_t (&bk)[kSTiles / 2][4]) {
        ldsm_x4(q_base + swz<kDh>(16 * mt + (lm & 1) * 8 + lr,
                                  2 * ks + (lm >> 1)), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np)
          if (np * 16 < P16)
            ldsm_x4(k_s + tswz(16 * np + (lm >> 1) * 8 + lr,
                               2 * ks + (lm & 1), P16),
                    bk[np][0], bk[np][1], bk[np][2], bk[np][3]);
      };
      if (kSBuf == 2) load_s(0, qa[0], kb[0]);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        if (kSBuf == 1)
          load_s(ks, qa[0], kb[0]);
        else if (ks + 1 < kKSteps)
          load_s(ks + 1, qa[(ks + 1) % kSBuf], kb[(ks + 1) % kSBuf]);
        const uint32_t* a = qa[ks % kSBuf];
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          if (np * 16 < P16) {
            const uint32_t* bk = kb[ks % kSBuf][np];
            mma_bf16(s[2 * np], a[0], a[1], a[2], a[3], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
          }
        }
      }
      // online softmax in base 2 (m, and the split partials, are in
      // log2 units): scale, mask, row max over the quad
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = 8 * n + 2 * tq + e < rows;
          s[n][e] = ok ? s[n][e] * scale2 : kNegInf;
          s[n][2 + e] = ok ? s[n][2 + e] * scale2 : kNegInf;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = 8 * n + 2 * tq + e < rows;
          s[n][e] = ok ? exp2f(s[n][e] - mn0) : 0.f;
          s[n][2 + e] = ok ? exp2f(s[n][2 + e] - mn1) : 0.f;
          sum0 += s[n][e];
          sum1 += s[n][2 + e];
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = al0 * l0 + sum0;
      l1 = al1 * l1 + sum1;
#pragma unroll
      for (int n = 0; n < kChunks; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
      // the card signal from the f32 p: a row above its page's mean for
      // any real head of the m-tile, OR over the quads
      uint32_t bits = 0;
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if ((hv0 && s[n][e] * fP > sum0) ||
              (hv1 && s[n][2 + e] * fP > sum1))
            bits |= 1u << (2 * n + e);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        bits |= __shfl_xor_sync(0xffffffffu, bits, off);
      // lane l stores rows 2l and 2l + 1: bits 2 (l / 4) and 2 (l / 4) + 1
      // of the lanes with tq = l % 4
      bits = __shfl_sync(0xffffffffu, bits, lane & 3) >> (2 * (lane >> 2));
      uint8_t* u = used + col * P + 2 * lane;
      if (bits & 1) u[0] = 1;
      if (bits & 2) u[1] = 1;
    }

    landed(2 * p + 1);                 // V of this page
    if (live && rows < P16) {
      // zero the V rows past page_lens: p = 0 there, and 0 x NaN is NaN
      unsigned char* vz = ring + ((2 * p + 1) % kRing) * item_bytes;
      for (int i = ttid; i < (P16 - rows) * kChunks; i += team_threads)
        *reinterpret_cast<uint4*>(vz + tswz(rows + i / kChunks, i % kChunks,
                                            P16)) = make_uint4(0, 0, 0, 0);
      fence_async_smem();              // before the slot's next TMA write
    }
    team_sync(team + 1, team_threads); // and this page's K slot is free
    issue(2 * p + 3, next_frame, next_rows);   // into this page's K slot
    if (live) {
      // acc += P V, P straight from the S fragments (rounded to bf16); up
      // to Dh 128 the V fragments of the next 16 rows are loaded before
      // the products of these (at Dh 256 they would not fit in registers)
      constexpr int kVBuf = kDh <= 128 ? 2 : 1;
      uint32_t vb[kVBuf][kChunks / 2][4];
      auto load_v = [&](int ks, uint32_t (&b)[kChunks / 2][4]) {
#pragma unroll
        for (int dp = 0; dp < kChunks / 2; ++dp)
          ldsm_x4_t(v_s + tswz(16 * ks + (lm & 1) * 8 + lr,
                               2 * dp + (lm >> 1), P16),
                    b[dp][0], b[dp][1], b[dp][2], b[dp][3]);
      };
      if (kVBuf == 2) load_v(0, vb[0]);
#pragma unroll
      for (int ks = 0; ks < kSTiles / 2; ++ks) {
        if (ks * 16 < P16) {
          if (kVBuf == 1)
            load_v(ks, vb[0]);
          else if (ks + 1 < kSTiles / 2 && (ks + 1) * 16 < P16)
            load_v(ks + 1, vb[(ks + 1) % kVBuf]);
          const uint32_t a0 = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
          const uint32_t a1 = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
          const uint32_t a2 = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
          const uint32_t a3 = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
          for (int dp = 0; dp < kChunks / 2; ++dp) {
            const uint32_t* b = vb[ks % kVBuf][dp];
            mma_bf16(acc[2 * dp], a0, a1, a2, a3, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], a0, a1, a2, a3, b[2], b[3]);
          }
        }
      }
    }
    frame = next_frame;
    rows = next_rows;
  }
  // every copy issued has landed (the last two items copy nothing)
  __syncthreads();

  // the teams' partials, combined in team order: a warp per head, the
  // team weights in lanes 0..teams-1
  constexpr int kRed = kDh + 4;      // padded row: 2-way bank conflicts at most
  constexpr int kDPerLane = kDh / 32;
  const int tr = teams * rows_pad;
  float* red = reinterpret_cast<float*>(smem);   // [teams, rows_pad, kRed]
  float* red_m = red + tr * kRed;                // [teams, rows_pad]
  float* red_l = red_m + tr;
  const int r0 = team * rows_pad + 16 * mt + gq;
#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    red[r0 * kRed + 8 * n + 2 * tq] = acc[n][0];
    red[r0 * kRed + 8 * n + 2 * tq + 1] = acc[n][1];
    red[(r0 + 8) * kRed + 8 * n + 2 * tq] = acc[n][2];
    red[(r0 + 8) * kRed + 8 * n + 2 * tq + 1] = acc[n][3];
  }
  if (tq == 0) {
    red_m[r0] = m0;
    red_m[r0 + 8] = m1;
    red_l[r0] = l0;
    red_l[r0 + 8] = l1;
  }
  __syncthreads();
  const int64_t GD = (int64_t)G * Dh;
  const int64_t ps = (int64_t)bh * n_split + split;
  const int n_warps = blockDim.x >> 5;
  for (int hh = warp; hh < G; hh += n_warps) {
    const float mt_ = lane < teams ? red_m[lane * rows_pad + hh] : kNegInf;
    const float mx = warp_max(mt_);
    const float wl = lane < teams ? exp2f(mt_ - mx) : 0.f;
    float l = 0.f;
    for (int t = 0; t < teams; ++t)
      l += __shfl_sync(0xffffffffu, wl, t) * red_l[t * rows_pad + hh];
    float a[kDPerLane];                          // dims lane + 32 k
#pragma unroll
    for (int k = 0; k < kDPerLane; ++k) a[k] = 0.f;
    for (int t = 0; t < teams; ++t) {
      const float w = __shfl_sync(0xffffffffu, wl, t);
      const float* row = red + (t * rows_pad + hh) * kRed + lane;
#pragma unroll
      for (int k = 0; k < kDPerLane; ++k) a[k] += w * row[32 * k];
    }
#pragma unroll
    for (int k = 0; k < kDPerLane; ++k) {
      const int d = lane + 32 * k;
      if (d < Dh) {
        if (n_split == 1)
          out[bh * GD + hh * Dh + d] =
              __float2bfloat16_rn(a[k] / fmaxf(l, 1e-30f));
        else
          acc_part[ps * GD + hh * Dh + d] = a[k];
      }
    }
    if (n_split > 1 && lane == 0) {
      m_part[ps * G + hh] = mx;
      l_part[ps * G + hh] = l;
    }
  }
  if (n_split == 1) return;

  // flash-decoding: the last block of this pair to finish combines the
  // splits, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + bh, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // shared memory: m and l of every split [n_split, G], then the splits'
  // partial sums for a chunk of heads, staged by cp.async (all copies in
  // flight at once)
  float* ms = reinterpret_cast<float*>(smem);
  float* ls = ms + n_split * G;
  const int st_off = (2 * n_split * G + 3) & ~3;
  float* st = ms + st_off;
  uint32_t smem_bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(smem_bytes));
  const int nh_max = min(G, ((int)(smem_bytes / 4) - st_off) / n_split / Dh);
  const int chunk = nh_max * Dh;
  const int64_t pb = (int64_t)bh * n_split;
  auto stage = [&](int h0) {
    const int nv = min(nh_max, G - h0) * Dh / 4;
    for (int sp = warp; sp < n_split; sp += n_warps)
      for (int v = lane; v < nv; v += 32)
        cp_async16(smem_u32(st + sp * chunk + 4 * v),
                   acc_part + (pb + sp) * GD + h0 * Dh + 4 * v, 16);
    cp_commit();
  };
  stage(0);
  for (int i = tid; i < n_split * G; i += blockDim.x) {
    ms[i] = __ldcg(m_part + pb * G + i);
    ls[i] = __ldcg(l_part + pb * G + i);
  }
  for (int h0 = 0; h0 < G; h0 += nh_max) {
    if (h0 > 0) stage(h0);
    cp_wait<0>();
    __syncthreads();
    for (int hh = h0 + warp; hh < min(G, h0 + nh_max); hh += n_warps) {
      float mx = kNegInf;
      for (int sp = lane; sp < n_split; sp += 32)
        mx = fmaxf(mx, ms[sp * G + hh]);
      mx = warp_max(mx);
      __syncwarp();
      for (int sp = lane; sp < n_split; sp += 32)    // m -> split weight
        ms[sp * G + hh] = exp2f(ms[sp * G + hh] - mx);
      __syncwarp();
      float l = 0.f, a[kDPerLane];                   // dims lane + 32 k
#pragma unroll
      for (int k = 0; k < kDPerLane; ++k) a[k] = 0.f;
      for (int sp = 0; sp < n_split; ++sp) {
        const float w = ms[sp * G + hh];
        const float* row = st + sp * chunk + (hh - h0) * Dh + lane;
        l += w * ls[sp * G + hh];
#pragma unroll
        for (int k = 0; k < kDPerLane; ++k)
          if (lane + 32 * k < Dh) a[k] += w * row[32 * k];
      }
#pragma unroll
      for (int k = 0; k < kDPerLane; ++k)
        if (lane + 32 * k < Dh)
          out[bh * GD + hh * Dh + lane + 32 * k] =
              __float2bfloat16_rn(a[k] / fmaxf(l, 1e-30f));
    }
    __syncthreads();
  }
  if (tid == 0) counters[bh] = 0;    // ready for the next launch
}

// dynamic shared memory of the tensor-core kernel, 0 if over the limit
inline size_t mma_smem(int k_dh, int page_rows, int m_tiles, int teams,
                       int group, int n_split) {
  const size_t P16 = (size_t)((page_rows + 15) & ~15);
  const size_t rows_pad = 16 * (size_t)m_tiles;
  const size_t stage =
      rows_pad * k_dh * 2 + 1024 + teams * kRing * P16 * k_dh * 2;
  const size_t red = 4 * teams * rows_pad * (k_dh + 6);
  // the split combine: m and l, and one head's partial sums per split
  const size_t comb =
      n_split > 1 ? 4 * (2 * (size_t)n_split * group + 4 +
                         (size_t)n_split * k_dh)
                  : 0;
  size_t s = stage > red ? stage : red;
  s = s > comb ? s : comb;
  return s <= (size_t)kMmaSmemLimit ? s : 0;
}

template <int kDh>
cudaError_t launch_mma(const CUtensorMap& k_map, const CUtensorMap& v_map,
                       const void* q, const int32_t* pt, const int32_t* pl,
                       void* out,
                       uint8_t* used, float* m_part, float* l_part,
                       float* acc_part, int* counters, int64_t batch,
                       int kv_heads, int group, int head_dim,
                       int64_t n_frames, int page_rows, int n_pages,
                       int n_split, int pages_per_split, int m_tiles,
                       int teams, float scale, cudaStream_t s) {
  const size_t smem = mma_smem(kDh, page_rows, m_tiles, teams, group,
                               n_split);
  if (smem == 0) return cudaErrorInvalidValue;
  auto kern = paged_attention_mma_kernel<kDh>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(batch * kv_heads), (unsigned)n_split);
  kern<<<grid, 32 * m_tiles * teams, smem, s>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), pt, pl,
      static_cast<__nv_bfloat16*>(out), used, m_part, l_part, acc_part,
      counters, kv_heads, group, head_dim, n_frames, page_rows, n_pages,
      n_split, pages_per_split, m_tiles, teams, scale);
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// pages [KVH, F, P, Dh] bf16 as a 2-D tensor of KVH*F*P rows of Dh, read
// in boxes of 64 columns (128 bytes, swizzled) by p16 rows
cudaError_t page_map(CUtensorMap* map, const void* pages, int head_dim,
                     int64_t rows, int p16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)head_dim, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)head_dim * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)p16};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(pages), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_paged_attention_mma(
    int device, const void* q, const void* k, const void* v,
    const void* page_table, const void* page_lens, void* out, void* used,
    void* m_part, void* l_part, void* acc_part, void* counters,
    int64_t batch, int kv_heads, int group, int head_dim, int64_t n_frames,
    int page_rows, int n_pages, int n_split, int pages_per_split,
    int m_tiles, int teams, float scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (group < 1 || m_tiles != (group + 15) / 16 ||
      m_tiles > kMmaMaxTiles || teams < 1 ||
      32 * m_tiles * teams > kMmaThreads ||
      head_dim % 16 || head_dim > 256 || page_rows < 1 ||
      page_rows > kMmaMaxRows || n_split < 1 || n_split > kMaxSplit ||
      (int64_t)kv_heads * n_frames * page_rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)kv_heads * n_frames * page_rows;
  const int p16 = (page_rows + 15) & ~15;
  CUtensorMap k_map, v_map;
  e = page_map(&k_map, k, head_dim, rows, p16);
  if (e == cudaSuccess) e = page_map(&v_map, v, head_dim, rows, p16);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(used, 0, (size_t)(batch * n_pages * page_rows), s);
  if (e != cudaSuccess) return (int)e;
#define REPRO_PA_MMA_ARGS k_map, v_map, q,                                 \
    static_cast<const int32_t*>(page_table),                               \
    static_cast<const int32_t*>(page_lens), out,                           \
    static_cast<uint8_t*>(used), static_cast<float*>(m_part),              \
    static_cast<float*>(l_part), static_cast<float*>(acc_part),            \
    static_cast<int*>(counters), batch, kv_heads, group, head_dim,         \
    n_frames, page_rows, n_pages, n_split, pages_per_split, m_tiles,       \
    teams, scale, s
  if (head_dim <= 64) {
    e = launch_mma<64>(REPRO_PA_MMA_ARGS);
  } else if (head_dim <= 128) {
    e = launch_mma<128>(REPRO_PA_MMA_ARGS);
  } else {
    e = launch_mma<256>(REPRO_PA_MMA_ARGS);
  }
#undef REPRO_PA_MMA_ARGS
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}


extern "C" int repro_paged_attention(
    int device, const void* q, int q_bf16, const void* k, const void* v,
    int kv_bf16, const void* page_table, const void* page_lens, void* out,
    void* used, void* m_part, void* l_part, void* acc_part, int64_t batch,
    int kv_heads, int group, int head_dim, int64_t n_frames, int page_rows,
    int n_pages, int n_split, int pages_per_split, float scale,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (group < 1 || group > 8 || head_dim % 8 || head_dim > kMaxDh ||
      page_rows < 1 || page_rows > kMaxP || n_split < 1 ||
      n_split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(used, 0, (size_t)(batch * n_pages * page_rows), s);
  if (e != cudaSuccess) return (int)e;
  const int32_t* pt = static_cast<const int32_t*>(page_table);
  const int32_t* pl = static_cast<const int32_t*>(page_lens);
  uint8_t* u = static_cast<uint8_t*>(used);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
#define REPRO_PA_ARGS group, q, k, v, pt, pl, out, u, mp, lp, ap, batch, \
    kv_heads, head_dim, n_frames, page_rows, n_pages, n_split,           \
    pages_per_split, scale, s
  if (q_bf16 && kv_bf16) {
    e = dispatch_group<__nv_bfloat16, __nv_bfloat16>(REPRO_PA_ARGS);
  } else if (q_bf16) {
    e = dispatch_group<__nv_bfloat16, float>(REPRO_PA_ARGS);
  } else if (kv_bf16) {
    e = dispatch_group<float, __nv_bfloat16>(REPRO_PA_ARGS);
  } else {
    e = dispatch_group<float, float>(REPRO_PA_ARGS);
  }
#undef REPRO_PA_ARGS
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
