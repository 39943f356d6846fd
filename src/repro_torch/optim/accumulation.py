"""Gradient accumulation (port of ``repro.optim.accumulation``): a global
batch larger than fits activation memory, evaluated in ``num_micro``
micro-batches with one optimizer update.  JAX's steps: the batch's leading
dimension split into ``num_micro`` chunks, the gradients summed in f32 in
order, then the loss and every gradient multiplied by ``1/num_micro``."""
from __future__ import annotations

import torch

from ..tree import leaves, tree_map, value_and_grad


def accumulated_value_and_grad(loss_fn, num_micro: int):
    """fn(params, batch) -> (mean loss, grads), the loss evaluated in
    ``num_micro`` sequential micro-batches."""
    vg = value_and_grad(loss_fn)
    if num_micro <= 1:
        return vg

    def split(x):
        b = x.shape[0]
        if b % num_micro:
            raise ValueError(f"batch {b} does not split into {num_micro} "
                             f"micro-batches")
        return x.reshape((num_micro, b // num_micro) + tuple(x.shape[1:]))

    def fn(params, batch):
        micro = tree_map(split, batch)
        loss = grads = None
        for i in range(num_micro):
            l, g = vg(params, tree_map(lambda x: x[i], micro))
            if grads is None:      # 0 + g == g: JAX's first add, exactly
                loss, grads = l, tree_map(lambda x: x.to(torch.float32), g)
                continue
            loss = loss + l
            for a, b in zip(leaves(grads), leaves(g)):
                a.add_(b.to(torch.float32))
        inv = 1.0 / num_micro
        return loss * inv, tree_map(lambda x: x.mul_(inv), grads)

    return fn
