// gather_rows and gather_rows_into: the hybrid plane's row gather on Hopper.
//
// Replaces the Pallas kernel repro/kernels/gather_objects.py::gather_rows
// (one grid step per row, the row's HBM->VMEM DMA driven by a
// scalar-prefetched index).  gather_rows computes out[r] = pool[idx[r]] for
// a pool [N, D] and idx [R] int32, with a zero row where idx[r] < 0.
// gather_rows_into writes the same rows straight into their destination,
// dst[dst_idx[r]] = pool[idx[r]], so a caller that used to gather into a
// temporary and scatter it (the expert fetch, object ingress, the paging
// page-in) moves each byte once.  Both are counted as gather_rows.
//
// Bound: pure data movement, each needed row read once and written once
// plus 4 B (8 B with dst_idx) of indices a row.  At serving sizes (about
// 1,000 rows of 128 B, or 1 KiB pages) that is a few hundred KB, so the
// launch and the latency of two dependent loads (index, then row) bound
// it; the rows geometry of row_gather.cuh puts every row of a batch in
// flight in one wave.
// The expert fetch moves 8 rows of 29.36 MB, where the bytes bound it at
// HBM's 3.35 TB/s; the tiles geometry keeps every thread of a full grid
// with a 16-byte load in flight, with no division per word, and streams
// the copy past L2's default caching.
#include "row_gather.cuh"

// plan (kernels/gather_objects.py launch_plan): word_bytes, lanes, grid_x,
// grid_y, streaming
extern "C" int repro_gather_rows(int device, const void* pool, int64_t n_pool,
                                 const void* idx, int64_t n_rows, void* out,
                                 int64_t row_bytes, int word_bytes, int lanes,
                                 int grid_x, int grid_y, int streaming,
                                 void* stream) {
  return repro::launch_row_copy<repro::tag::gather_rows>(
      device,
      repro::row_copy_args(pool, n_pool, idx, n_rows, out, n_rows, nullptr,
                           row_bytes, word_bytes),
      word_bytes, lanes, grid_x, grid_y, streaming,
      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_gather_rows_into(int device, const void* pool,
                                      int64_t n_pool, const void* idx,
                                      int64_t n_rows, void* dst,
                                      int64_t n_dst, const void* dst_idx,
                                      int64_t row_bytes, int word_bytes,
                                      int lanes, int grid_x, int grid_y,
                                      int streaming, void* stream) {
  return repro::launch_row_copy<repro::tag::gather_rows>(
      device,
      repro::row_copy_args(pool, n_pool, idx, n_rows, dst, n_dst, dst_idx,
                           row_bytes, word_bytes),
      word_bytes, lanes, grid_x, grid_y, streaming,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
