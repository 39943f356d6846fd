// Shared device body of the row-copy kernels (gather_rows.cu,
// compact_pages.cu): dst[dst_idx[r]] = pool[idx[r]] for r < n_rows, a zero
// row where idx[r] < 0.  Without dst_idx the destination is row r itself
// (gather_rows, compact_pages); with it the rows land straight in place
// (gather_rows_into).
//
// Rows are copied as opaque words of type W (uint4 = 16 B, uint32_t = 4 B
// or uint8_t = 1 B), so one body serves every dtype.  An index outside
// [0, n_pool) reads nothing and yields zeros, and a destination outside
// [0, n_dst) is skipped, so no index can make a copy leave its tensors.
//
// One body, two geometries that the host (kernels/gather_objects.py,
// launch_plan) picks from the row's words.  A block is blockDim.x lanes
// (a power of two up to 256) by blockDim.y rows; lane x copies words x,
// x + lanes * gridDim.x, ... of its row, so no word offset needs a
// division.
//
//  * rows (a row fits one pass of its lanes: object rows, 1 KiB pages,
//    evacuator slots): each block takes a contiguous run of 256 / lanes
//    rows and the grid covers the batch, so all of its rows are in flight
//    in one wave.
//  * tiles (longer rows; the KV plane's 16 KiB pages, the expert fetch's
//    29.36 MB rows): 256 lanes a row, gridDim.y blocks walk the rows and
//    gridDim.x the row's chunks of 256 words, persistent where the plan
//    caps the grid.
//
// Every lane of a row reads the row's index itself: the lanes of a warp
// read one word, which is one transaction.  On the H100 this, and one
// 16-byte load in flight per thread across a full grid, measured faster
// than a broadcast of the index by one lane (__shfl_sync) and than four or
// eight loads in flight per thread (PERF.md section 6,
// tools/row_copy_variants.py).  kStream puts the streaming hint
// (ld/st.global.cs) on the copy: faster on copies of megabytes, slower on
// the small ones, so the plan sets it by the bytes moved.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// tags that name the entry point in the kernels' symbols (the profiler
// tells gather_rows' launches from compact_pages')
namespace tag {
struct gather_rows;
struct compact_pages;
}  // namespace tag

constexpr int kThreads = 256;   // lanes x rows of a block

template <bool kStream, typename W>
__device__ __forceinline__ W load_word(const W* p) {
  if constexpr (kStream) return __ldcs(p);
  else return __ldg(p);
}
template <bool kStream, typename W>
__device__ __forceinline__ void store_word(W* p, W w) {
  if constexpr (kStream) __stcs(p, w);
  else *p = w;
}

// kInto: the destination of row r is dst_idx[r] (gather_rows_into), else
// r.  The pointers are __restrict__ and the lookup is compiled out where
// there is none: both measured on the small copies (PERF.md section 6).
template <typename Tag, typename W, bool kInto, bool kStream>
__global__ void __launch_bounds__(kThreads) row_copy(
    const W* __restrict__ pool, int64_t n_pool,
    const int32_t* __restrict__ idx, int64_t n_rows, W* __restrict__ dst,
    int64_t n_dst, const int32_t* __restrict__ dst_idx, int wpr) {
  const int chunk = blockDim.x * gridDim.x;   // words a pass of the grid
  for (int64_t r = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
       r < n_rows; r += (int64_t)gridDim.y * blockDim.y) {
    // every lane reads the row's index: one transaction a warp
    const int32_t src = __ldg(idx + r);
    int64_t d = r;
    if constexpr (kInto) {
      d = __ldg(dst_idx + r);
      if (d < 0 || d >= n_dst) continue;
    }
    const bool ok = src >= 0 && src < n_pool;
    const W* s = pool + (int64_t)(ok ? src : 0) * wpr;
    W* o = dst + d * wpr;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < wpr; c += chunk)
      store_word<kStream>(o + c, ok ? load_word<kStream>(s + c) : W{});
  }
}

// ---- host side ------------------------------------------------------------
struct RowCopy {
  const void* pool;
  int64_t n_pool;
  const int32_t* idx;
  int64_t n_rows;
  void* dst;
  int64_t n_dst;
  const int32_t* dst_idx;   // nullptr: the destination of row r is r
  int wpr;                  // words per row
};

inline RowCopy row_copy_args(const void* pool, int64_t n_pool,
                             const void* idx, int64_t n_rows, void* dst,
                             int64_t n_dst, const void* dst_idx,
                             int64_t row_bytes, int word_bytes) {
  RowCopy a;
  a.pool = pool;
  a.n_pool = n_pool;
  a.idx = static_cast<const int32_t*>(idx);
  a.n_rows = n_rows;
  a.dst = dst;
  a.n_dst = n_dst;
  a.dst_idx = static_cast<const int32_t*>(dst_idx);
  a.wpr = (int)(row_bytes / word_bytes);
  return a;
}

template <typename Tag, typename W, bool kInto>
void launch_words(const RowCopy& a, dim3 grid, dim3 block, bool streaming,
                  cudaStream_t stream) {
  auto* pool = static_cast<const W*>(a.pool);
  auto* dst = static_cast<W*>(a.dst);
  if (streaming)
    row_copy<Tag, W, kInto, true><<<grid, block, 0, stream>>>(
        pool, a.n_pool, a.idx, a.n_rows, dst, a.n_dst, a.dst_idx, a.wpr);
  else
    row_copy<Tag, W, kInto, false><<<grid, block, 0, stream>>>(
        pool, a.n_pool, a.idx, a.n_rows, dst, a.n_dst, a.dst_idx, a.wpr);
}

template <typename Tag, typename W>
void launch_words(const RowCopy& a, dim3 grid, dim3 block, bool streaming,
                  cudaStream_t stream) {
  if (a.dst_idx) launch_words<Tag, W, true>(a, grid, block, streaming, stream);
  else launch_words<Tag, W, false>(a, grid, block, streaming, stream);
}

// plan (kernels/gather_objects.py launch_plan): word bytes, lanes a row,
// grid (x: chunks of a row, y: runs of rows), streaming hint
template <typename Tag>
int launch_row_copy(int device, const RowCopy& a, int word_bytes, int lanes,
                    int grid_x, int grid_y, int streaming,
                    cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (lanes < 1 || lanes > kThreads || (lanes & (lanes - 1)) || grid_x < 1 ||
      grid_y < 1 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const dim3 block((unsigned)lanes, (unsigned)(kThreads / lanes));
  const bool st = streaming != 0;
  switch (word_bytes) {
    case 16: launch_words<Tag, uint4>(a, grid, block, st, stream); break;
    case 4: launch_words<Tag, uint32_t>(a, grid, block, st, stream); break;
    case 1: launch_words<Tag, uint8_t>(a, grid, block, st, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro
