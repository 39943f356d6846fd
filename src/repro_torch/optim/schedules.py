"""LR schedules (port of ``repro.optim.schedules``): the cosine schedule
with warmup, re-exported, plus constant and linear warmup.  Each maps a
step (an int or a 0-d tensor) to a 0-d f32 tensor on the step's device."""
import torch

from .optimizers import cosine_schedule  # noqa: F401


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(base_lr: float, warmup: int):
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        return base_lr * torch.clamp_max(s / max(warmup, 1), 1.0)
    return lr
