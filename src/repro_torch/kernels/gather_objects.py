"""Row gather on the card: the wrappers of the hand-written CUDA kernels
``csrc/gather_rows.cu`` (the port of the Pallas kernel
``repro.kernels.gather_objects.gather_rows``).

- ``gather_rows``: ``pool [N, D], idx [R] int32 -> [R, D]``; a negative
  index yields a zero row.
- ``gather_rows_into``: ``dst[dst_idx[r]] = pool[idx[r]]`` (a zero row where
  ``idx[r] < 0``), in place, so a caller that gathered into a temporary and
  scattered it moves each byte once.

Rows are opaque words, so any dtype goes.  ``launch_plan`` picks the
kernel's geometry from the shapes and the pointers' alignment alone, so
the CPU tests can check it; the C entry points take the plan as
arguments.  The wrappers take CUDA tensors only (the dispatch in ``ops``
sends CPU tensors to the plain versions in ``ref``), launch on the current
stream and count each launch under ``launches``; ``launches_into`` counts
the ``gather_rows_into`` launches among them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

# geometry (row_gather.cuh): blocks of THREADS = lanes x rows; a row in
# one pass of its lanes is the rows regime, a longer one the tiles regime,
# whose grid is capped at BLOCKS_PER_SM resident blocks an SM.  Copies that
# move at least STREAM_BYTES take the streaming hint.
THREADS = 256             # kThreads
BLOCKS_PER_SM = 4
MAX_GRID_Y = 65535
STREAM_BYTES = 4 << 20
MAX_ROW_WORDS = 1 << 30   # word offsets within a row are 32-bit

launches = 0        # kernel launches since the last ops.reset_launch_counts()
launches_into = 0   # ... of them through gather_rows_into


class GatherPlan(NamedTuple):
    """One launch of the row-copy kernel (row_gather.cuh)."""
    regime: str          # "rows" (a row in one pass of its lanes) | "tiles"
    word_bytes: int      # 16, 4 or 1: the copy's word
    lanes: int           # lanes a row: a power of two <= THREADS
    grid_x: int          # blocks along a row's chunks of `lanes` words
    grid_y: int          # blocks along runs of THREADS // lanes rows
    streaming: bool      # ld/st.global.cs on the copy

    def c_args(self) -> tuple:
        """(word_bytes, lanes, grid_x, grid_y, streaming), as the C entry
        points take them."""
        return (self.word_bytes, self.lanes, self.grid_x, self.grid_y,
                int(self.streaming))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def word_bytes(row_bytes: int, *addresses: int) -> int:
    """The widest word (16, 4 or 1 bytes) that the row width and every
    base address allow."""
    a = row_bytes
    for p in addresses:
        a |= p
    return 16 if a % 16 == 0 else 4 if a % 4 == 0 else 1


def launch_plan(n_rows: int, row_bytes: int, *, word: int = 16,
                sms: int = 132) -> GatherPlan:
    """The kernel's geometry for ``n_rows`` rows of ``row_bytes`` copied in
    ``word``-byte words on a card of ``sms`` SMs.

    A row gets the least power of two of lanes, up to ``THREADS``, that
    covers it in one pass; a block takes ``THREADS // lanes`` rows.  Rows
    that fit one pass (the rows regime) are all launched in one wave;
    longer rows (the tiles regime) are cut into chunks of ``lanes`` words,
    and the grid is capped at ``BLOCKS_PER_SM`` blocks an SM, which walk
    the rest."""
    wpr = row_bytes // word
    if n_rows < 1 or row_bytes < 1 or row_bytes % word or \
            wpr >= MAX_ROW_WORDS:
        raise ValueError(f"gather plan: {n_rows} rows of {row_bytes} B in "
                         f"{word}-byte words")
    lanes = min(THREADS, _pow2_at_least(wpr))
    grid_y = min(-(-n_rows // (THREADS // lanes)), MAX_GRID_Y)
    chunks = -(-wpr // lanes)
    grid_x = min(chunks, -(-sms * BLOCKS_PER_SM // grid_y))
    return GatherPlan("rows" if chunks == 1 else "tiles", word, lanes,
                      grid_x, grid_y, 2 * n_rows * row_bytes >= STREAM_BYTES)


def sm_count(device_index: int) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _rows(name: str, pool: torch.Tensor, idx: torch.Tensor) -> None:
    if pool.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: pool [N, D] and idx [R], got "
                         f"{tuple(pool.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx int32, got {idx.dtype}")
    if not (pool.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: pool and idx must be contiguous")


def check_into(dst: torch.Tensor, dst_idx: torch.Tensor, pool: torch.Tensor,
               idx: torch.Tensor) -> None:
    """Raise unless ``dst [M, D]`` and ``pool [N, D]`` share dtype and row
    width, all four are contiguous, ``dst`` and ``pool`` do not overlap,
    and ``dst_idx``/``idx`` are int32 vectors of one length.  Both dispatch
    paths check this."""
    _rows("gather_rows_into", pool, idx)
    if dst.dim() != 2 or dst_idx.shape != idx.shape:
        raise ValueError(f"gather_rows_into: dst [M, D] and dst_idx [R] "
                         f"beside idx [R], got {tuple(dst.shape)}, "
                         f"{tuple(dst_idx.shape)}, {tuple(idx.shape)}")
    if dst_idx.dtype != torch.int32:
        raise ValueError(f"gather_rows_into: dst_idx int32, got "
                         f"{dst_idx.dtype}")
    if dst.dtype != pool.dtype or dst.shape[1] != pool.shape[1]:
        raise ValueError(f"gather_rows_into: dst and pool differ in dtype or "
                         f"row width: {dst.dtype} {tuple(dst.shape)} and "
                         f"{pool.dtype} {tuple(pool.shape)}")
    if not (dst.is_contiguous() and dst_idx.is_contiguous()):
        raise ValueError("gather_rows_into: dst and dst_idx must be "
                         "contiguous")
    if dst.device == pool.device and dst.nbytes and pool.nbytes \
            and not dst.is_meta:       # a meta tensor has no storage
        a, b = dst.data_ptr(), pool.data_ptr()
        if a < b + pool.nbytes and b < a + dst.nbytes:
            raise ValueError("gather_rows_into: dst and pool overlap")


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """CUDA row gather.  pool [N, D] (any dtype), idx [R] int32."""
    global launches
    dev = _build.require_cuda("gather_rows", pool=pool, idx=idx)
    _rows("gather_rows", pool, idx)
    N, D = pool.shape
    R = idx.shape[0]
    out = torch.empty((R, D), dtype=pool.dtype, device=pool.device)
    row_bytes = D * pool.element_size()
    if R == 0 or D == 0:
        return out
    plan = launch_plan(R, row_bytes, sms=sm_count(dev),
                       word=word_bytes(row_bytes, pool.data_ptr(),
                                       out.data_ptr()))
    err = _build.load_library().repro_gather_rows(
        dev, pool.data_ptr(), N, idx.data_ptr(), R, out.data_ptr(), row_bytes,
        *plan.c_args(), _build.stream_ptr(dev))
    _build.check(err, "gather_rows")
    launches += 1
    return out


def gather_rows_into(dst: torch.Tensor, dst_idx: torch.Tensor,
                     pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """CUDA in-place gather: ``dst[dst_idx[r]] = pool[idx[r]]`` (zeros where
    ``idx[r] < 0``); returns ``dst``.  Destinations of rows with a valid
    source must be distinct; rows that share a destination must carry the
    same data (a caller's trash row).  A destination outside ``[0, M)``
    is skipped."""
    global launches, launches_into
    dev = _build.require_cuda("gather_rows_into", dst=dst, dst_idx=dst_idx,
                              pool=pool, idx=idx)
    check_into(dst, dst_idx, pool, idx)
    N, D = pool.shape
    R = idx.shape[0]
    row_bytes = D * pool.element_size()
    if R == 0 or D == 0:
        return dst
    plan = launch_plan(R, row_bytes, sms=sm_count(dev),
                       word=word_bytes(row_bytes, pool.data_ptr(),
                                       dst.data_ptr()))
    err = _build.load_library().repro_gather_rows_into(
        dev, pool.data_ptr(), N, idx.data_ptr(), R, dst.data_ptr(),
        dst.shape[0], dst_idx.data_ptr(), row_bytes, *plan.c_args(),
        _build.stream_ptr(dev))
    _build.check(err, "gather_rows_into")
    launches += 1
    launches_into += 1
    return dst
