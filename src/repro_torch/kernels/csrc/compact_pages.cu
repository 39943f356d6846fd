// compact_pages: the evacuator's page assembly on Hopper.
//
// Replaces the Pallas kernel repro/kernels/compact.py::compact_pages (a
// (M, P) grid, each step DMA-ing the source row that the scalar-prefetched
// move plan names into one slot of a destination page).  Computes pages
// [M, P, D] from a frame pool [N, D] and a flat plan [M*P] int32 of source
// rows; a -1 slot is zero-filled (a fresh log page's empty slots).
//
// Bound: pure data movement, 2*M*P*D*itemsize bytes (32 KB for the
// evacuator's M=4 destination pages of P=8 rows of 32 f32), so one launch
// and one dependent load bound it.  It shares the flat-word gather body of
// gather_rows (row_gather.cuh), which puts every word of every slot in
// flight at once; it is its own entry point so that its launches are
// counted apart from the serving gathers.
#include "row_gather.cuh"

namespace {

template <typename W>
__global__ void __launch_bounds__(repro::kGatherThreads)
compact_pages_kernel(const W* __restrict__ pool, int64_t n_pool,
                     const int32_t* __restrict__ plan, W* __restrict__ out,
                     int64_t n_slots, int64_t words_per_row) {
  repro::gather_body<W>(pool, n_pool, plan, out, n_slots, words_per_row);
}

template <typename W>
void launch(const void* pool, int64_t n_pool, const int32_t* plan, void* out,
            int64_t n_slots, int64_t row_bytes, cudaStream_t stream) {
  const int64_t wpr = row_bytes / (int64_t)sizeof(W);
  compact_pages_kernel<W>
      <<<repro::gather_blocks(n_slots * wpr), repro::kGatherThreads, 0,
         stream>>>(static_cast<const W*>(pool), n_pool, plan,
                   static_cast<W*>(out), n_slots, wpr);
}

}  // namespace

extern "C" int repro_compact_pages(int device, const void* pool,
                                   int64_t n_pool, const void* plan,
                                   int64_t n_slots, void* out,
                                   int64_t row_bytes, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int32_t* pl = static_cast<const int32_t*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (repro::gather_word_bytes(pool, out, row_bytes)) {
    case 16: launch<uint4>(pool, n_pool, pl, out, n_slots, row_bytes, s); break;
    case 4: launch<uint32_t>(pool, n_pool, pl, out, n_slots, row_bytes, s); break;
    default: launch<uint8_t>(pool, n_pool, pl, out, n_slots, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}
