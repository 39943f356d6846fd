"""Card-access-table update on the card: the wrapper of the hand-written
CUDA kernel ``csrc/cat_update.cu`` (the port of the Pallas kernel
``repro.kernels.cat_update.cat_update``).

``cat_bits [V, W] int32 (the uint32 words of the JAX version), vaddrs [R]
int32 (-1 = skip) -> (bits [V, W] int32, car [V] f32)``: the touched card
bits ORed in, duplicates included, and popcount/page_objs per page.
CUDA tensors only.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0    # kernel launches since the last ops.reset_launch_counts()


def cat_update(cat_bits: torch.Tensor, vaddrs: torch.Tensor, *,
               page_objs: int):
    """CUDA CAT update.  cat_bits [V, W] int32, vaddrs [R] int32."""
    global launches
    dev = _build.require_cuda("cat_update", cat_bits=cat_bits, vaddrs=vaddrs)
    if cat_bits.dim() != 2 or vaddrs.dim() != 1:
        raise ValueError(f"cat_update: cat_bits [V, W] and vaddrs [R], got "
                         f"{tuple(cat_bits.shape)} and {tuple(vaddrs.shape)}")
    if cat_bits.dtype != torch.int32 or vaddrs.dtype != torch.int32:
        raise ValueError(f"cat_update: int32 words and vaddrs, got "
                         f"{cat_bits.dtype} and {vaddrs.dtype}")
    V, W = cat_bits.shape
    if page_objs < 1 or W != -(-page_objs // 32):
        raise ValueError(f"cat_update: {W} words per page for "
                         f"page_objs={page_objs}")
    bits = torch.empty_like(cat_bits)
    car = torch.empty((V,), dtype=torch.float32, device=cat_bits.device)
    if V == 0:
        return bits, car
    err = _build.load_library().repro_cat_update(
        dev, cat_bits.data_ptr(), vaddrs.data_ptr(), bits.data_ptr(),
        car.data_ptr(), V, W, vaddrs.shape[0], page_objs,
        _build.stream_ptr(dev))
    _build.check(err, "cat_update")
    launches += 1
    return bits, car
