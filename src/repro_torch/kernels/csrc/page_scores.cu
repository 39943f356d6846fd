// page_scores: the KV plane's offload-space page scoring on Hopper.
//
// Replaces the Pallas kernel repro/kernels/topk_pages.py::page_scores (grid
// (B, KVH, NP/128), each step a [G, 128, Dh] elementwise bound reduced over
// Dh and G in VMEM).  For every sequence b, kv head h and page n:
//
//   out[b, h, n] = max_g sum_d max(q[b,h,g,d] * kmax[h,n,d], q[b,h,g,d] * kmin[h,n,d])
//
// with q [B, KVH, G, Dh] (f32 or bf16, taken in f32) and the page summaries
// kmax/kmin [KVH, NP, Dh] f32.  Both maxima propagate NaN as jnp.maximum
// does: an unwritten page (kmax = -inf, kmin = +inf) meets a zero q_d as
// NaN, which the caller masks; the kernel must not trap on it, and does
// not.
//
// Bound: bytes.  The summaries are read once, 2*KVH*NP*Dh*4 bytes: 67 MB
// for llama3-8b's long_500k plane (KVH 8, NP 8192, Dh 128), 20 us at
// 3.35 TB/s.  The arithmetic is 3 operations per summary element, far
// below the card's rate.  Design: the block's q head group sits in shared
// memory as f32; each warp scores one page at a time with 16-byte loads
// (one float4 of kmax and one of kmin per lane for Dh = 128, so a warp
// reads 1 KiB of each summary contiguously), sums each query head over
// its lane's elements and then across the warp by shuffles, and keeps the
// maximum over the group.  Pages are spread over blocks of 8 warps so
// that a 65,536-page scan fills every SM.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxDh = 256;
constexpr int kChunks = kMaxDh / 4 / 32;   // float4 chunks per lane, at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float bound4(const float* q, float4 hi, float4 lo) {
  return nan_max(q[0] * hi.x, q[0] * lo.x) + nan_max(q[1] * hi.y, q[1] * lo.y) +
         nan_max(q[2] * hi.z, q[2] * lo.z) + nan_max(q[3] * hi.w, q[3] * lo.w);
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
page_scores_kernel(const TQ* __restrict__ q, const float* __restrict__ kmax,
                   const float* __restrict__ kmin, float* __restrict__ out,
                   int kv_heads, int group, int n_pages, int head_dim,
                   int pages_per_block) {
  __shared__ float q_s[kMaxG * kMaxDh];
  const int h = blockIdx.y, b = blockIdx.z;
  const TQ* qb = q + ((int64_t)b * kv_heads + h) * group * head_dim;
  for (int i = threadIdx.x; i < group * head_dim; i += kThreads)
    q_s[i] = to_f(qb[i]);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = head_dim / 4;
  const int64_t first = (int64_t)blockIdx.x * pages_per_block;
  for (int i = warp; i < pages_per_block; i += kWarps) {
    const int64_t n = first + i;
    if (n >= n_pages) break;                       // warp-uniform
    const int64_t row = ((int64_t)h * n_pages + n) * head_dim;
    const float4* hi = reinterpret_cast<const float4*>(kmax + row);
    const float4* lo = reinterpret_cast<const float4*>(kmin + row);
    float4 a[kChunks], c[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int ch = lane + 32 * k;
      if (ch < n_chunks) {
        a[k] = __ldg(hi + ch);
        c[k] = __ldg(lo + ch);
      }
    }
    float best = 0.f;
    for (int g = 0; g < group; ++g) {
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int ch = lane + 32 * k;
        if (ch < n_chunks) part += bound4(q_s + g * head_dim + ch * 4, a[k], c[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      best = g == 0 ? part : nan_max(best, part);
    }
    if (lane == 0) out[((int64_t)b * kv_heads + h) * n_pages + n] = best;
  }
}

}  // namespace

extern "C" int repro_page_scores(int device, const void* q, int q_bf16,
                                 const void* kmax, const void* kmin, void* out,
                                 int64_t batch, int kv_heads, int group,
                                 int n_pages, int head_dim, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (group < 1 || group > kMaxG || head_dim % 4 || head_dim > kMaxDh)
    return (int)cudaErrorInvalidValue;
  const int pages_per_block = 64;
  dim3 grid((unsigned)((n_pages + pages_per_block - 1) / pages_per_block),
            (unsigned)kv_heads, (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(kmax);
  const float* mn = static_cast<const float*>(kmin);
  float* o = static_cast<float*>(out);
  if (q_bf16) {
    page_scores_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), mx, mn, o, kv_heads, group,
        n_pages, head_dim, pages_per_block);
  } else {
    page_scores_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), mx, mn, o, kv_heads, group, n_pages,
        head_dim, pages_per_block);
  }
  return (int)cudaGetLastError();
}
