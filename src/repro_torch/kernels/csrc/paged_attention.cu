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
// Design.  Per page: (1) each row's G dot products, a group of lanes per
// row (8 elements per lane, shuffle-reduced), into shared memory; (2) one
// warp per query head updates m and l, turns the scores into p and marks
// the used rows; (3) each thread accumulates 8 output dims for all G
// heads over a strided subset of rows, its partial sums kept in registers
// across pages.  Row groups are reduced in a fixed order at the end, so
// the result is the same from run to run.  The three phases of a page
// depend on each other, so a block that loaded K and V as it went would
// wait on memory twice per page; the staged variant instead copies the
// NEXT page's K and V rows into shared memory with cp.async (two
// buffers) while it computes on this one, which keeps 32 KB a block in
// flight for bf16 pages of 64 x 128.  Pages whose two buffers do not fit
// (4 * P * Dh * itemsize > 128 KB) take the unstaged variant, which reads
// K and V straight from device memory.  No configuration of the repo
// reaches it (its pages are 64 x 128, 64 KB staged in bf16, 128 KB in
// f32): it serves only the larger pages the kernel accepts, P up to 128
// with Dh up to 256.  With few (sequence, head) pairs
// -- B = 1 in sparse mode gives 8 -- the pages are split over blocks
// (flash-decoding), about one block per SM, and a second kernel combines
// the partial (m, l, acc) in split order.
#include <cstdint>
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

}  // namespace

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
