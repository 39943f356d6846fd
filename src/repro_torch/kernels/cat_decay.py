"""Epoch CAR EMA on the card: the wrapper of the hand-written CUDA kernel
``csrc/cat_decay.cu`` (the port of the Pallas kernel
``repro.kernels.cat_decay.cat_decay``).

``cat [V, P] bool, car_ema [V] f32, alloc [V] int32 -> [V] f32`` with
``f32(decay)*ema + f32(1-decay)*popcount(cat)/max(alloc, 1)``, bit for bit
the f32 operation order of ``ref.cat_decay_ref``.  CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0    # kernel launches since the last ops.reset_launch_counts()


def cat_decay(cat: torch.Tensor, car_ema: torch.Tensor, alloc: torch.Tensor,
              *, decay: float) -> torch.Tensor:
    """CUDA CAR EMA.  cat [V, P] bool, car_ema [V] f32, alloc [V] int32."""
    global launches
    dev = _build.require_cuda("cat_decay", cat=cat, car_ema=car_ema,
                              alloc=alloc)
    V = cat.shape[0]
    if (cat.dim() != 2 or tuple(car_ema.shape) != (V,)
            or tuple(alloc.shape) != (V,)):
        raise ValueError(f"cat_decay: cat [V, P], car_ema [V], alloc [V], "
                         f"got {tuple(cat.shape)}, {tuple(car_ema.shape)}, "
                         f"{tuple(alloc.shape)}")
    if (cat.dtype != torch.bool or car_ema.dtype != torch.float32
            or alloc.dtype != torch.int32):
        raise ValueError(f"cat_decay: cat bool, car_ema f32, alloc int32, "
                         f"got {cat.dtype}, {car_ema.dtype}, {alloc.dtype}")
    out = torch.empty((V,), dtype=torch.float32, device=cat.device)
    if V == 0:
        return out
    # both constants rounded to f32 on the host; 1 - decay in double first,
    # as jnp.float32(1.0 - decay) does
    err = _build.load_library().repro_cat_decay(
        dev, cat.data_ptr(), car_ema.data_ptr(), alloc.data_ptr(),
        out.data_ptr(), V, cat.shape[1], ctypes.c_float(decay),
        ctypes.c_float(1.0 - decay), _build.stream_ptr(dev))
    _build.check(err, "cat_decay")
    launches += 1
    return out
