"""Access-pattern workload generators for the plane benchmarks — the
analogues of the paper's application suite (Table 1).  The port's own copy
of ``repro.data.kvworkload`` (numpy only): the same seed yields the same
batches.

Each generator yields batches of object ids with a characteristic pattern:

  * ``zipf_churn``   — MCD-CL: skewed with churn (hot set drifts over time)
  * ``uniform``      — MCD-U: uniform random, no hot set
  * ``two_phase``    — Metis PVC/WC: random-insert Map phase, then
                       sequential-scan Reduce phase (with optional skew runs)
  * ``graph_iter``   — GPR/ATC: random build, then repeated near-identical
                       iteration orders with a drifting update fraction
  * ``scan``         — DF Copy: pure sequential
  * ``grouped``      — WS: requests touch small co-accessed groups (32 keys)
"""
from __future__ import annotations

import numpy as np


def zipf_ranks(rng, n_objs, size, alpha=1.05):
    r = rng.zipf(alpha, size=size)
    return np.minimum(r - 1, n_objs - 1).astype(np.int32)


def zipf_churn(n_objs: int, batch: int, steps: int, *, alpha=1.05,
               churn_every=50, seed=0):
    """Skewed accesses whose identity mapping rotates (hot set drifts)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_objs)
    for t in range(steps):
        if t and t % churn_every == 0:
            # drift: re-map 10% of the id space
            k = n_objs // 10
            idx = rng.choice(n_objs, size=k, replace=False)
            perm[idx] = perm[np.roll(idx, 1)]
        yield perm[zipf_ranks(rng, n_objs, batch, alpha)].astype(np.int32)


def uniform(n_objs: int, batch: int, steps: int, *, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield rng.integers(0, n_objs, size=batch).astype(np.int32)


def two_phase(n_objs: int, batch: int, steps: int, *, skew_runs=True, seed=0):
    """Map phase (first half): random inserts, with occasional sequential
    runs when the data is skewed (paper Fig 1a).  Reduce phase (second
    half): sequential scan."""
    rng = np.random.default_rng(seed)
    half = steps // 2
    pos = 0
    for t in range(steps):
        if t < half:
            ids = rng.integers(0, n_objs, size=batch)
            if skew_runs and rng.random() < 0.25:
                start = rng.integers(0, max(n_objs - batch, 1))
                ids = np.arange(start, start + batch) % n_objs
            yield ids.astype(np.int32)
        else:
            ids = (pos + np.arange(batch)) % n_objs
            pos = (pos + batch) % n_objs
            yield ids.astype(np.int32)


def graph_iter(n_objs: int, batch: int, steps: int, *, build_frac=0.3,
               update_frac=0.05, seed=0):
    """Evolving-graph analytics: random build phase, then iterations that
    reuse a fixed traversal order, perturbed by graph updates."""
    rng = np.random.default_rng(seed)
    build = int(steps * build_frac)
    order = rng.permutation(n_objs)
    pos = 0
    for t in range(steps):
        if t < build:
            yield rng.integers(0, n_objs, size=batch).astype(np.int32)
        else:
            ids = order[(pos + np.arange(batch)) % n_objs].copy()
            n_upd = int(batch * update_frac)
            if n_upd:
                ids[:n_upd] = rng.integers(0, n_objs, size=n_upd)
            pos = (pos + batch) % n_objs
            yield ids.astype(np.int32)


def scan(n_objs: int, batch: int, steps: int, *, seed=0):
    pos = 0
    for _ in range(steps):
        yield ((pos + np.arange(batch)) % n_objs).astype(np.int32)
        pos = (pos + batch) % n_objs


def grouped(n_objs: int, batch: int, steps: int, *, group=32, alpha=1.05,
            seed=0):
    """WS-style: each request reads a zipf-chosen group of ``group``
    consecutive keys (keys co-accessed within a request)."""
    rng = np.random.default_rng(seed)
    n_groups = max(n_objs // group, 1)
    per = max(batch // group, 1)
    for _ in range(steps):
        g = zipf_ranks(rng, n_groups, per, alpha)
        ids = (g[:, None] * group + np.arange(group)[None, :]).reshape(-1)
        yield ids[:batch].astype(np.int32)


WORKLOADS = {
    "mcd_cl": zipf_churn,
    "mcd_u": uniform,
    "metis": two_phase,
    "graph": graph_iter,
    "df_scan": scan,
    "ws": grouped,
}
