"""Evacuation page assembly on the card: the wrapper of the hand-written
CUDA kernel ``csrc/compact_pages.cu`` (the port of the Pallas kernel
``repro.kernels.compact.compact_pages``).

``pool [N, D], plan [M*P] int32 -> pages [M, P, D]``; a ``-1`` slot is
zero-filled.  The kernel shares gather_rows' row-copy body and its
``launch_plan``.  CUDA tensors only (``ops`` sends CPU tensors to
``ref.compact_pages_ref``).
"""
from __future__ import annotations

import torch

from . import _build
from .gather_objects import launch_plan, sm_count, word_bytes

launches = 0    # kernel launches since the last ops.reset_launch_counts()


def compact_pages(pool: torch.Tensor, plan: torch.Tensor, *,
                  page_objs: int) -> torch.Tensor:
    """CUDA page assembly.  pool [N, D] (any dtype), plan [M*P] int32."""
    global launches
    dev = _build.require_cuda("compact_pages", pool=pool, plan=plan)
    if pool.dim() != 2 or plan.dim() != 1 or plan.shape[0] % page_objs:
        raise ValueError(f"compact_pages: pool [N, D] and plan [M*P] with "
                         f"P={page_objs}, got {tuple(pool.shape)} and "
                         f"{tuple(plan.shape)}")
    if plan.dtype != torch.int32:
        raise ValueError(f"compact_pages: plan int32, got {plan.dtype}")
    N, D = pool.shape
    M = plan.shape[0] // page_objs
    out = torch.empty((M, page_objs, D), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    row_bytes = D * pool.element_size()
    lp = launch_plan(plan.shape[0], row_bytes, sms=sm_count(dev),
                     word=word_bytes(row_bytes, pool.data_ptr(),
                                     out.data_ptr()))
    err = _build.load_library().repro_compact_pages(
        dev, pool.data_ptr(), N, plan.data_ptr(), plan.shape[0],
        out.data_ptr(), row_bytes, *lp.c_args(), _build.stream_ptr(dev))
    _build.check(err, "compact_pages")
    launches += 1
    return out
