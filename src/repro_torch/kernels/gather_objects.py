"""Row gather on the card: the wrapper of the hand-written CUDA kernel
``csrc/gather_rows.cu`` (the port of the Pallas kernel
``repro.kernels.gather_objects.gather_rows``).

``pool [N, D], idx [R] int32 -> [R, D]``; a negative index yields a zero
row.  The wrapper takes CUDA tensors only (the dispatch in ``ops`` sends
CPU tensors to ``ref.gather_rows_ref``), allocates the output, launches on
the current stream and counts the launch.
"""
from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
launches = 0    # kernel launches since the last ops.reset_launch_counts()


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """CUDA row gather.  pool [N, D] (f32 or bf16), idx [R] int32."""
    global launches
    dev = _build.require_cuda("gather_rows", pool=pool, idx=idx)
    if pool.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: pool [N, D] and idx [R], got "
                         f"{tuple(pool.shape)} and {tuple(idx.shape)}")
    if pool.dtype not in DTYPES or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: pool f32/bf16 and idx int32, got "
                         f"{pool.dtype} and {idx.dtype}")
    N, D = pool.shape
    R = idx.shape[0]
    out = torch.empty((R, D), dtype=pool.dtype, device=pool.device)
    if R == 0 or D == 0:
        return out
    err = _build.load_library().repro_gather_rows(
        dev, pool.data_ptr(), N, idx.data_ptr(), R, out.data_ptr(),
        D * pool.element_size(), _build.stream_ptr(dev))
    _build.check(err, "gather_rows")
    launches += 1
    return out
