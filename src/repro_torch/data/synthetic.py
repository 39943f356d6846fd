"""Deterministic synthetic data (port of ``repro.data.synthetic``):
step-indexed, so a restarted job resumes exactly where it left off (no
replay, no skipped batches) — the data side of fault tolerance.

Numpy only, on the host: under the same numpy the batches are the JAX
package's, bit for bit.  A batch is built from ``default_rng`` seeded with
``seed * 1_000_003 + step``, so any host can rebuild any step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # zipf exponent of the token distribution
    zipf_alpha: float = 1.1


def batch_for_step(cfg: DataConfig, step: int, *, with_labels: bool = True,
                   frontend: Optional[dict] = None) -> dict:
    """The batch of a global step: ``tokens`` [B, S] int32 (zipf ranks),
    ``labels`` the tokens shifted left with -1 last, and for each
    ``frontend`` entry ``name: (shape, dtype)`` standard normal
    [B, *shape]."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    ranks = rng.zipf(cfg.zipf_alpha, size=(cfg.global_batch, cfg.seq_len))
    tokens = np.minimum(ranks - 1, cfg.vocab - 1).astype(np.int32)
    out = {"tokens": tokens}
    if with_labels:
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((cfg.global_batch, 1), -1, np.int32)],
                                axis=1)
        out["labels"] = labels
    if frontend:
        for name, (shape, dtype) in frontend.items():
            out[name] = rng.standard_normal(
                (cfg.global_batch,) + tuple(shape)).astype(dtype)
    return out


def stream(cfg: DataConfig, start_step: int = 0, **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_for_step(cfg, step, **kw)
        step += 1
