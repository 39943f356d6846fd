// gather_rows: the hybrid plane's row gather on Hopper.
//
// Replaces the Pallas kernel repro/kernels/gather_objects.py::gather_rows
// (one grid step per row, the row's HBM->VMEM DMA driven by a
// scalar-prefetched index).  Computes out[r] = pool[idx[r]] for a pool
// [N, D] and idx [R] int32, with a zero row where idx[r] < 0.  The plane
// calls it for object ingress, for both final-read gathers and, through
// gather_pages (a row = one whole page of P*D elements), for every page-in.
//
// Bound: pure data movement, about 2*R*D*itemsize bytes plus 4*R of
// indices.  At serving sizes (R ~ 1000 rows of 128 B, or pages of 1 KiB)
// that is a few hundred KB, so the launch and the latency of one dependent
// load (index, then row) bound it, not the 3.35 TB/s of HBM.  The design
// answers with a flat word index space (row_gather.cuh): every thread
// issues one independent 16-byte load, so all rows are in flight at once
// and a 1024-row batch fills the card in a single wave.
#include "row_gather.cuh"

namespace {

template <typename W>
__global__ void __launch_bounds__(repro::kGatherThreads)
gather_rows_kernel(const W* __restrict__ pool, int64_t n_pool,
                   const int32_t* __restrict__ idx, W* __restrict__ out,
                   int64_t n_rows, int64_t words_per_row) {
  repro::gather_body<W>(pool, n_pool, idx, out, n_rows, words_per_row);
}

template <typename W>
void launch(const void* pool, int64_t n_pool, const int32_t* idx, void* out,
            int64_t n_rows, int64_t row_bytes, cudaStream_t stream) {
  const int64_t wpr = row_bytes / (int64_t)sizeof(W);
  gather_rows_kernel<W>
      <<<repro::gather_blocks(n_rows * wpr), repro::kGatherThreads, 0,
         stream>>>(static_cast<const W*>(pool), n_pool, idx,
                   static_cast<W*>(out), n_rows, wpr);
}

}  // namespace

extern "C" int repro_gather_rows(int device, const void* pool, int64_t n_pool,
                                 const void* idx, int64_t n_rows, void* out,
                                 int64_t row_bytes, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (repro::gather_word_bytes(pool, out, row_bytes)) {
    case 16: launch<uint4>(pool, n_pool, ix, out, n_rows, row_bytes, s); break;
    case 4: launch<uint32_t>(pool, n_pool, ix, out, n_rows, row_bytes, s); break;
    default: launch<uint8_t>(pool, n_pool, ix, out, n_rows, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
