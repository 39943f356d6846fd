// Shared device body of the row-gather kernels (gather_rows.cu,
// compact_pages.cu): out[r] = pool[idx[r]], or a zero row where idx[r] < 0.
//
// Rows are copied as opaque words of type W (uint4 = 16 B, uint32_t = 4 B
// or uint8_t = 1 B; the host picks the widest one that the row width and
// the pointers' alignment allow), so one body serves every dtype.  The
// R x (row_bytes / sizeof(W)) words form one flat index space: neighbouring
// threads copy neighbouring words of a row, and of the next row, so loads
// and stores coalesce whatever the row width (a 128 B object row is 8
// uint4 words, a 1 KiB page 64).  Each thread reads its row's index itself:
// there is no scalar prefetch on the GPU, and the index words hit L1.
//
// An index outside [0, n_pool) reads nothing and yields zeros, so a bad
// index can never read outside the pool.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kGatherThreads = 256;

template <typename W>
__device__ __forceinline__ void gather_body(const W* __restrict__ pool,
                                            int64_t n_pool,
                                            const int32_t* __restrict__ idx,
                                            W* __restrict__ out,
                                            int64_t n_rows,
                                            int64_t words_per_row) {
  const int64_t total = n_rows * words_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const int64_t r = g / words_per_row;
    const int64_t c = g - r * words_per_row;
    const int32_t src = __ldg(idx + r);
    W w{};
    if (src >= 0 && src < n_pool) {
      w = __ldg(pool + (int64_t)src * words_per_row + c);
    }
    out[g] = w;
  }
}

// Launch geometry: enough blocks to cover the words, capped at a few waves
// of 132 SMs (the loop above strides over the rest).
inline unsigned gather_blocks(int64_t total_words) {
  int64_t b = (total_words + kGatherThreads - 1) / kGatherThreads;
  const int64_t cap = 132 * 16;
  if (b > cap) b = cap;
  return (unsigned)(b < 1 ? 1 : b);
}

// Widest word the row width and both pointers allow: 16, 4 or 1 bytes.
inline int gather_word_bytes(const void* pool, const void* out,
                             int64_t row_bytes) {
  const uintptr_t a = (uintptr_t)pool | (uintptr_t)out;
  if (row_bytes % 16 == 0 && a % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

}  // namespace repro
