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
// and one dependent load bound it.  It shares the row-copy body of
// gather_rows (row_gather.cuh) and takes its rows geometry: a group of
// lanes owns each slot, and every slot's words are in flight at once.  It is its own entry
// point so that its launches are counted apart from the serving gathers.
#include "row_gather.cuh"

// plan (kernels/gather_objects.py launch_plan): word_bytes, lanes, grid_x,
// grid_y, streaming
extern "C" int repro_compact_pages(int device, const void* pool,
                                   int64_t n_pool, const void* plan,
                                   int64_t n_slots, void* out,
                                   int64_t row_bytes, int word_bytes,
                                   int lanes, int grid_x, int grid_y,
                                   int streaming, void* stream) {
  return repro::launch_row_copy<repro::tag::compact_pages>(
      device,
      repro::row_copy_args(pool, n_pool, plan, n_slots, out, n_slots, nullptr,
                           row_bytes, word_bytes),
      word_bytes, lanes, grid_x, grid_y, streaming,
      static_cast<cudaStream_t>(stream));
}
