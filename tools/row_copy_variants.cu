// Row-copy designs timed beside the port's row_gather.cuh by
// tools/row_copy_variants.py.  out[r] = pool[idx[r]], a zero row where
// idx[r] is outside [0, n_pool); 16-byte words only.
//
//  * flat: the port's first body: one flat word index over
//    R x words_per_row, a 64-bit division and a reload of the row's index
//    per word, 256 threads a block, at most 132 * 16 blocks striding over
//    the rest.
//  * rows8 / tiles8: the two regimes of the first redesign: a group of at
//    most 32 lanes a row (first lane loads the index, __shfl_sync
//    broadcasts it) in blocks of 128 threads; (row, chunk) tiles of
//    64 KiB found by one division a tile, walked by four persistent
//    blocks of 256 threads an SM; eight loads in flight a thread, the
//    streaming hint on loads and stores.
//  * port_v<U, kShfl>: row_gather.cuh's body with its arguments in a
//    struct (no __restrict__), U loads in flight a thread, and with kShfl
//    the row's index broadcast by one lane.
#include <cstdint>
#include <cuda_runtime.h>

#include "row_gather.cuh"

namespace {

__global__ void flat(const uint4* __restrict__ pool, int64_t n_pool,
                     const int32_t* __restrict__ idx, uint4* __restrict__ out,
                     int64_t n_rows, int64_t words_per_row) {
  const int64_t total = n_rows * words_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const int64_t r = g / words_per_row;
    const int64_t c = g - r * words_per_row;
    const int32_t src = __ldg(idx + r);
    uint4 w{};
    if (src >= 0 && src < n_pool) {
      w = __ldg(pool + (int64_t)src * words_per_row + c);
    }
    out[g] = w;
  }
}

constexpr int kUnroll = 8;

__global__ void rows8(const uint4* __restrict__ pool, int64_t n_pool,
                      const int32_t* __restrict__ idx, uint4* __restrict__ out,
                      int64_t n_rows, int wpr, int lanes) {
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / lanes) +
                    threadIdx.x / lanes;
  int32_t src = -1;
  if (sub == 0 && r < n_rows) src = __ldg(idx + r);
  src = __shfl_sync(0xffffffffu, src, 0, lanes);
  if (r >= n_rows) return;
  const bool ok = src >= 0 && src < n_pool;
  const uint4* s = pool + (int64_t)(ok ? src : 0) * wpr;
  uint4* o = out + r * wpr;
  for (int base = sub; base < wpr; base += lanes * kUnroll) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * lanes;
      w[u] = uint4{};
      if (ok && c < wpr) w[u] = __ldcs(s + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * lanes;
      if (c < wpr) __stcs(o + c, w[u]);
    }
  }
}

__global__ void tiles8(const uint4* __restrict__ pool, int64_t n_pool,
                       const int32_t* __restrict__ idx, uint4* __restrict__ out,
                       int64_t n_rows, int64_t wpr, int64_t tw,
                       int64_t tiles_per_row) {
  const int64_t n_tiles = n_rows * tiles_per_row;
  const int64_t step = (int64_t)blockDim.x * kUnroll;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tiles_per_row;
    const int64_t c0 = (t - r * tiles_per_row) * tw;
    const int64_t c1 = c0 + tw < wpr ? c0 + tw : wpr;
    const int32_t src = __ldg(idx + r);
    const bool ok = src >= 0 && src < n_pool;
    const uint4* s = pool + (ok ? src : 0) * wpr;
    uint4* o = out + r * wpr;
    for (int64_t base = c0 + threadIdx.x; base < c1; base += step) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = base + (int64_t)u * blockDim.x;
        w[u] = uint4{};
        if (ok && c < c1) w[u] = __ldcs(s + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = base + (int64_t)u * blockDim.x;
        if (c < c1) __stcs(o + c, w[u]);
      }
    }
  }
}

// row_gather.cuh's body with U loads in flight a thread (lane x copies
// words x + j * lanes * gridDim.x, U of them before any store), and with
// kShfl the row's index loaded by the first lane of each warp's share of
// the row and broadcast with __shfl_sync
template <int U, bool kShfl, bool kStream>
__global__ void __launch_bounds__(256) port_v(repro::RowCopy a) {
  const int lanes = blockDim.x;
  const int width = lanes < 32 ? lanes : 32;
  const int chunk = lanes * gridDim.x;
  // the row loop is uniform across the block, so a warp's lanes all reach
  // each __shfl_sync
  for (int64_t rb = (int64_t)blockIdx.y * blockDim.y; rb < a.n_rows;
       rb += (int64_t)gridDim.y * blockDim.y) {
    const int64_t r = rb + threadIdx.y;
    int32_t src = -1;
    if (kShfl) {
      if ((threadIdx.x & (width - 1)) == 0 && r < a.n_rows)
        src = __ldg(a.idx + r);
      src = __shfl_sync(0xffffffffu, src, 0, width);
    } else if (r < a.n_rows) {
      src = __ldg(a.idx + r);
    }
    if (r >= a.n_rows) continue;
    const bool ok = src >= 0 && src < a.n_pool;
    const uint4* s = static_cast<const uint4*>(a.pool) +
                     (int64_t)(ok ? src : 0) * a.wpr;
    uint4* o = static_cast<uint4*>(a.dst) + r * a.wpr;
    for (int base = blockIdx.x * lanes + threadIdx.x; base < a.wpr;
         base += chunk * U) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * chunk;
        w[u] = uint4{};
        if (ok && c < a.wpr) w[u] = repro::load_word<kStream>(s + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * chunk;
        if (c < a.wpr) repro::store_word<kStream>(o + c, w[u]);
      }
    }
  }
}

}  // namespace

extern "C" int rcv_flat(const void* pool, int64_t n_pool, const void* idx,
                        int64_t n_rows, void* out, int64_t row_bytes,
                        void* stream) {
  const int64_t wpr = row_bytes / 16, total = n_rows * wpr;
  int64_t blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  flat<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), n_pool,
      static_cast<const int32_t*>(idx), static_cast<uint4*>(out), n_rows,
      wpr);
  return (int)cudaGetLastError();
}

// the first redesign: rows of at most 4 KiB take rows8, longer ones tiles8
extern "C" int rcv_first(const void* pool, int64_t n_pool, const void* idx,
                         int64_t n_rows, void* out, int64_t row_bytes,
                         void* stream) {
  auto* p = static_cast<const uint4*>(pool);
  auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t wpr = row_bytes / 16;
  if (row_bytes <= 4096) {
    int lanes = 1;
    while (lanes < wpr && lanes < 32) lanes *= 2;
    const int per_block = 128 / lanes;
    rows8<<<(unsigned)((n_rows + per_block - 1) / per_block), 128, 0, s>>>(
        p, n_pool, ix, o, n_rows, (int)wpr, lanes);
  } else {
    const int64_t tile = row_bytes < 65536 ? row_bytes : 65536;
    const int64_t tpr = (row_bytes + tile - 1) / tile;
    int64_t blocks = n_rows * tpr;
    if (blocks > 132 * 4) blocks = 132 * 4;
    tiles8<<<(unsigned)blocks, 256, 0, s>>>(p, n_pool, ix, o, n_rows, wpr,
                                            tile / 16, tpr);
  }
  return (int)cudaGetLastError();
}

// port_v at the plan's geometry: U in {1, 4, 8} loads a thread, or U = 1
// with the index broadcast by one lane (shfl = 1)
extern "C" int rcv_port_v(int unroll, int shfl, int streaming,
                          const void* pool, int64_t n_pool, const void* idx,
                          int64_t n_rows, void* out, int64_t row_bytes,
                          int lanes, int grid_x, int grid_y, void* stream) {
  const repro::RowCopy a = repro::row_copy_args(
      pool, n_pool, idx, n_rows, out, n_rows, nullptr, row_bytes, 16);
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const dim3 block((unsigned)lanes, (unsigned)(256 / lanes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = streaming != 0;
  if (unroll == 1 && shfl) {
    if (st) port_v<1, true, true><<<grid, block, 0, s>>>(a);
    else port_v<1, true, false><<<grid, block, 0, s>>>(a);
  } else if (unroll == 1) {
    if (st) port_v<1, false, true><<<grid, block, 0, s>>>(a);
    else port_v<1, false, false><<<grid, block, 0, s>>>(a);
  } else if (unroll == 4 && !shfl) {
    if (st) port_v<4, false, true><<<grid, block, 0, s>>>(a);
    else port_v<4, false, false><<<grid, block, 0, s>>>(a);
  } else if (unroll == 8 && !shfl) {
    if (st) port_v<8, false, true><<<grid, block, 0, s>>>(a);
    else port_v<8, false, false><<<grid, block, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

