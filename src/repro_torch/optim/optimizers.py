"""Optimizers (port of ``repro.optim.optimizers``): AdamW and Adafactor
(factored second moments, the trillion-parameter option), with
global-norm clipping and the cosine schedule.

``init(params) -> state``; ``update(grads, state, params, step) ->
(params, state, gnorm)``.  The arithmetic is JAX's, in f32 and in its
order.  Where JAX returns new trees, ``update`` writes the new parameters
and state into the tensors it was given (under ``torch.no_grad``) and
returns them: at full width a second copy of the parameters and moments
would not fit beside the activations.  ``step`` is a 0-d int tensor on the
parameters' device, so no step reads a value back to the host.

AdamW is elementwise and keeps its moments in the parameters' layout (per
layer lists).  Adafactor's statistics and its update clipping reach across
a stacked leaf, so it works on JAX's stacked leaves (``stacked``): its
state ``{"f": ...}`` has JAX's structure and shapes, and each stacked
update is written back into the per-layer tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..tree import flatten_with_path, leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in f32, the leaves summed
    one after another (the port's leaf order: per-layer leaves where JAX
    has stacked ones, so the sum rounds differently)."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(grads, max_norm: float):
    """(scale, norm): the factor that brings the global norm to at most
    ``max_norm``."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return scale, norm


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), norm


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


# --------------------------------------------------------------------------
# JAX's stacked leaves over the port's per-layer lists
# --------------------------------------------------------------------------

class Stack:
    """One leaf of JAX's stacked layout: the port's per-layer tensors
    ``parts`` (layer-major) that JAX stacks on the ``lead`` axes."""

    def __init__(self, parts: list, lead: tuple):
        self.parts, self.lead = parts, lead
        self.shape = lead + tuple(parts[0].shape)

    def value(self) -> torch.Tensor:
        if not self.lead:
            return self.parts[0]
        return torch.stack(self.parts).reshape(self.shape)

    def assign(self, new: torch.Tensor) -> None:
        for t, n in zip(self.parts, new.reshape((-1,) + self.shape[
                len(self.lead):])):
            t.copy_(n)


def _zip(items: list):
    if isinstance(items[0], dict):
        return {k: _zip([it[k] for it in items]) for k in items[0]}
    return Stack([t for it in items for t in it.parts],
                 (len(items),) + items[0].lead)


def stacked(tree):
    """The port's tree (dicts, per-layer lists) in JAX's stacked layout:
    dicts of ``Stack`` leaves."""
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _zip([stacked(x) for x in tree])
    return Stack([tree], ())


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable = cosine_schedule(3e-4, 100, 10000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        scale, gnorm = _clip_scale(grads, self.clip)
        t = (torch.as_tensor(step) + 1).to(torch.float32)
        lr = self.lr(step)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        for g, mu, nu, p in zip(leaves(grads), leaves(state["mu"]),
                                leaves(state["nu"]), leaves(params)):
            g = _scaled(g, scale).to(torch.float32)
            mu.copy_(self.b1 * mu + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu + (1 - self.b2) * g * g)
            step_ = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            pf = p.to(torch.float32)
            p.copy_(pf - lr * (step_ + self.weight_decay * pf))
        return params, state, gnorm


# --------------------------------------------------------------------------
# Adafactor (factored 2nd moments)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable = cosine_schedule(1e-3, 100, 10000)
    decay: float = 0.8      # beta2 exponent: 1 - t^-decay
    eps: float = 1e-30
    clip: float = 1.0

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def init(self, params):
        def per(s: Stack):
            dev = s.parts[0].device
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=dev)
            if self._factored(s.shape):
                return {"vr": z(s.shape[:-1]),
                        "vc": z(s.shape[:-2] + s.shape[-1:])}
            return {"v": z(s.shape)}
        return {"f": tree_map(per, stacked(params))}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        scale, gnorm = _clip_scale(grads, self.clip)
        t = (torch.as_tensor(step) + 1).to(torch.float32)
        beta2 = 1.0 - t ** (-self.decay)
        lr = self.lr(step)
        for (path, ps), gs in zip(flatten_with_path(stacked(params)),
                                  leaves(stacked(grads))):
            fac = _at(state["f"], path)
            g = _scaled(gs.value(), scale).to(torch.float32)
            g2 = g * g + self.eps
            if self._factored(ps.shape):
                vr = beta2 * fac["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * fac["vc"] + (1 - beta2) * g2.mean(-2)
                rms = (vr[..., :, None] * vc[..., None, :]
                       / torch.clamp_min(vr.mean(-1)[..., None, None],
                                         self.eps))
                u = g * torch.rsqrt(torch.clamp_min(rms, self.eps))
                fac["vr"].copy_(vr)
                fac["vc"].copy_(vc)
            else:
                v = beta2 * fac["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, self.eps))
                fac["v"].copy_(v)
            # update clipping (Adafactor's d = 1.0 RMS rule)
            u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)), 1.0)
            p = ps.value()
            ps.assign((p.to(torch.float32) - lr * u).to(p.dtype))
        return params, state, gnorm


def get_optimizer(name: str, **kw):
    return {"adamw": AdamW, "adafactor": Adafactor}[name](**kw)
