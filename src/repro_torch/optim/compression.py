"""Gradient compression (port of ``repro.optim.compression``): int8
error-feedback quantization with a per-tensor scale.  The quantization
residual is fed back into the next step's gradient.  ``torch.round``
rounds half to even, as ``jnp.round`` does."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: torch.Tensor


def init_ef(params):
    return tree_map(lambda p: EFState(torch.zeros(
        p.shape, dtype=torch.float32, device=p.device)), params)


def quantize(g: torch.Tensor, residual: torch.Tensor):
    """Returns (q int8, scale, new_residual)."""
    g = g.to(torch.float32) + residual
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g - deq


def compress_tree(grads, ef_state):
    """Quantize every leaf with error feedback; returns (q_tree, scales,
    new_ef)."""
    qs, scales, res = [], [], []
    for g, e in zip(leaves(grads), leaves(ef_state)):
        q, s, r = quantize(g, e)
        qs.append(q)
        scales.append(s)
        res.append(EFState(r))
    return (unflatten(grads, qs), unflatten(grads, scales),
            unflatten(grads, res))


def decompress_tree(q_tree, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scales)
