"""Functional module system + common layers (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors with the JAX package's key
names.  A model is defined as a tree of :class:`ParamDef` (shape +
initializer + logical partition spec); ``init_params`` materializes it.
Where JAX stacks a layer axis onto every leaf for ``lax.scan``, the port
keeps a list of per-layer trees (``stack_layers``) and loops over it.

The logical sharding specs are kept for the mesh slice; ``shard`` and
``pspecs`` wait for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

DP = "dp"
TP = "tp"
BATCH = "batch"


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple                      # logical partition spec (strings / None)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: Any = torch.float32

    def initialize(self, generator: torch.Generator, device) -> torch.Tensor:
        """One tensor drawn from ``generator`` in its own dtype (a bf16
        draw needs no f32 temporary: one kimi-k2 expert tensor is 11 GB in
        bf16)."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "normal":
            fan_in = self.shape[0] if len(self.shape) == 1 else self.shape[-2]
            std = self.scale / math.sqrt(max(fan_in, 1))
        elif self.init == "embed":
            std = self.scale
        else:
            raise ValueError(self.init)
        x = torch.empty(self.shape, dtype=self.dtype, device=device)
        return x.normal_(0.0, std, generator=generator)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _map(fn, tree):
    if is_def(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    raise TypeError(f"not a parameter tree: {type(tree)}")


def init_params(defs, generator: torch.Generator, device="cuda"):
    """Every leaf of ``defs`` drawn from ``generator``, one tensor at a
    time, in the tree's order."""
    return _map(lambda d: d.initialize(generator, device), defs)


def stack_layers(defs, n: int) -> list:
    """``n`` layers of ``defs``: the list the port loops over where JAX
    scans over a leading layer axis."""
    return [defs] * n


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.to(torch.float32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding.  x: [..., S, H, Dh]; positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), -ar / half)
    angles = positions[..., None].to(torch.float32) * freq    # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out], the output in x's dtype (JAX's
    ``preferred_element_type=x.dtype``: bf16 in, bf16 out)."""
    return torch.matmul(x, w)
