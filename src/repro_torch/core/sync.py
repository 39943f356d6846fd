"""Synchronization protocol between the two paths, paper §4.2 (PyTorch
port of ``repro.core.sync``).

The per-page deref counts (``PlaneState.pin``) realize the invariants the
paths rely on: pinned pages are never victims (``paths._victim_frame``,
``batch._plan_victims``) and are skipped by evacuation.  This module has
the batched pin helpers a host-side runtime uses to hold pins across
scheduler ticks, and the live-lock guard of §4.2: when too much data is
pinned, pinned pages are forced onto the paging path so they can be
swapped out and paged back in without pointer updates.  Every function
updates the state in place; none syncs with the host.
"""
from __future__ import annotations

import torch

from . import state as st
from .layout import LOCAL, PlaneConfig


def _pin_add(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
             delta: int) -> st.PlaneState:
    """``pin[page of each object] += delta``; duplicates accumulate, and a
    negative index wraps as in JAX (over the logical, trash-free rows)."""
    O, V = cfg.num_objs, cfg.num_vpages
    v = s.obj_loc[:O][obj_ids.long()] // cfg.page_objs
    pin = s.pin[:V]
    pin.index_put_((v.long(),), torch.full(v.shape, delta, dtype=pin.dtype,
                                           device=pin.device),
                   accumulate=True)
    return s


def pin_objects(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor
                ) -> st.PlaneState:
    """Open a dereference scope for each object (duplicates accumulate)."""
    return _pin_add(cfg, s, obj_ids, 1)


def unpin_objects(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor
                  ) -> st.PlaneState:
    """Close the scopes opened by :func:`pin_objects`."""
    return _pin_add(cfg, s, obj_ids, -1)


def pinned_fraction(cfg: PlaneConfig, s: st.PlaneState) -> torch.Tensor:
    """Fraction of local frames whose page is pinned (live-lock monitor)."""
    v = s.vpage_of[:cfg.num_frames]
    pinned = (v >= 0) & (s.pin[v.clamp_min(0)] > 0)
    return pinned.to(torch.float32).mean()


def force_paging_under_pressure(cfg: PlaneConfig, s: st.PlaneState,
                                threshold: float = 0.75) -> st.PlaneState:
    """Paper §4.2 live-lock mitigation: under memory pressure, flip the PSF
    of pinned local pages to ``paging`` so that, once their scopes close,
    they can be swapped out and re-fetched without pointer updates."""
    V = cfg.num_vpages
    pressure = pinned_fraction(cfg, s) >= threshold
    pinned_local = (s.backing[:V] == LOCAL) & (s.pin[:V] > 0)
    s.psf[:V] |= pressure & pinned_local
    return s
