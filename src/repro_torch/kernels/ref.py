"""Plain PyTorch versions of the kernels on the hybrid plane's path.

Each ``<name>_ref`` has the semantics of the JAX package's Pallas kernel of
the same name (``repro.kernels``).  The CPU tests use them, the dispatch in
``ops`` takes them for CPU tensors, and the chip smoke test holds each CUDA
kernel against them on the card.  None of them is a matrix product, so
the TF32 settings do not touch them (the chip smoke test turns TF32 off
all the same).
"""
from __future__ import annotations

import torch


def gather_rows_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool [N, D], idx [R] int32 -> [R, D]; a negative index yields a zero
    row."""
    rows = pool[idx.clamp_min(0)]
    return torch.where((idx >= 0)[:, None], rows, torch.zeros_like(rows))


def compact_pages_ref(pool: torch.Tensor, plan: torch.Tensor,
                      page_objs: int) -> torch.Tensor:
    """pool [N, D], plan [M*P] flat row ids (-1 = zero slot) -> [M, P, D]."""
    M = plan.shape[0] // page_objs
    return gather_rows_ref(pool, plan).reshape(M, page_objs, pool.shape[-1])


def cat_decay_ref(cat: torch.Tensor, car_ema: torch.Tensor,
                  alloc: torch.Tensor, decay: float) -> torch.Tensor:
    """Epoch CAR EMA: cat [V, P] bool (or 0/1 ints), car_ema [V] f32,
    alloc [V] int32 -> ``f32(decay)*ema + f32(1-decay)*popcount/max(alloc,1)``
    in the f32 operation order of ``repro.kernels.ref.cat_decay_ref``."""
    cnt = cat.to(torch.float32).sum(dim=1)
    car = cnt / alloc.clamp_min(1).to(torch.float32)
    d = torch.full((), decay, dtype=torch.float32, device=car.device)
    # 1 - decay in Python double, then rounded to f32 (jnp.float32(1 - d))
    e = torch.full((), 1.0 - decay, dtype=torch.float32, device=car.device)
    return d * car_ema + e * car
