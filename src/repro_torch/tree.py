"""Trees of tensors, in ``jax.tree_util``'s order, and the gradient of a
function of one.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
numpy arrays, or Python numbers) at the leaves; ``None`` holds no leaf.
Dict keys are visited sorted, as ``jax.tree_util`` visits them, so a
checkpoint's leaf order and names (``checkpoint.ckpt``) and a sum over the
leaves (``optim.global_norm``) follow JAX's.
"""
from __future__ import annotations

from typing import Callable

import torch


def _children(node):
    """(keys, children) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return node._fields, list(node)
    if isinstance(node, (list, tuple)):
        return list(range(len(node))), list(node)
    if node is None:
        return [], []
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, tuple):
        return tuple(children)
    if isinstance(node, list):
        return list(children)
    return None


def flatten_with_path(tree) -> list:
    """[(path, leaf)]: the path is the keys (dict key, sequence index or
    NamedTuple field name) from the root down to the leaf."""
    kc = _children(tree)
    if kc is None:
        return [((), tree)]
    out = []
    for k, c in zip(*kc):
        out += [((k,) + p, leaf) for p, leaf in flatten_with_path(c)]
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template, flat: list):
    """``template``'s structure with its leaves replaced, in order, by
    ``flat``."""
    it = iter(flat)

    def build(node):
        kc = _children(node)
        if kc is None:
            return next(it)
        return _rebuild(node, [build(c) for c in kc[1]])
    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` of each leaf of ``tree`` and the leaves at the same places
    in ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad`` over a tree of tensors: ``fn(params, *args)``
    -> (value, gradient tree of ``params``' structure), through
    ``torch.autograd``.  The value is detached; a leaf that ``fn`` does not
    reach gets a zero gradient, as in JAX."""
    def vg(params, *args, **kw):
        flat = leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in flat]
            out = fn(unflatten(params, live), *args, **kw)
            grads = torch.autograd.grad(out, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return out.detach(), unflatten(params, grads)
    return vg


def device_of(tree) -> torch.device:
    """The device of the first tensor leaf (the CPU if there is none)."""
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")

