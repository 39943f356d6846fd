"""Computation offloading, paper §4.3 (PyTorch port of
``repro.core.offload``).

The far tier (slab) is addressable without staging rows into frames,
because a page's vaddrs never move at page-out (slab slot id == vpage
id).  Running a function "on the remote side" is a reduction run directly
against the page's storage that returns only its (small) result.  The
offload bit of the paper's smart pointer becomes an extra pin, so the
existing victim and evacuation masking respect it.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels import ops as kops
from . import state as st
from .layout import REMOTE, PlaneConfig
from .paths import add


def remote_apply(cfg: PlaneConfig, s: st.PlaneState, vpages: torch.Tensor,
                 fn: Callable[[torch.Tensor], torch.Tensor]):
    """Run ``fn`` (``[P, D] -> [...]``, mapped over the pages with
    ``torch.func.vmap``) on pages without fetching them.  Each page is read
    from exactly one tier by two masked ``gather_rows`` calls over whole
    pages (a page's index into the other tier is ``-1``), so the frame and
    the slab copy of a page are never both moved.  A page that is not
    REMOTE is read from its frame.  Returns ``(state, results)``; the pages
    stay pinned (offload-busy) until :func:`remote_release`."""
    P, D, V, F = cfg.page_objs, cfg.obj_dim, cfg.num_vpages, cfg.num_frames
    local = s.backing[vpages] != REMOTE
    fidx = torch.where(local, s.frame_of[vpages].clamp_min(0), -1)
    sidx = torch.where(local, -1, vpages)
    from_frames = kops.gather_rows(s.frames[:F].view(F, P * D), fidx,
                                   impl=cfg.kernel_impl)
    from_slab = kops.gather_rows(s.slab[:V].view(V, P * D), sidx,
                                 impl=cfg.kernel_impl)
    pages = torch.where(local[:, None], from_frames, from_slab).view(-1, P, D)
    results = torch.func.vmap(fn)(pages)
    add(s.pin, vpages, 1)                         # offload-busy
    return s, results


def remote_release(cfg: PlaneConfig, s: st.PlaneState, vpages: torch.Tensor
                   ) -> st.PlaneState:
    """Clear the offload-busy pins taken by :func:`remote_apply`."""
    add(s.pin, vpages, -1)
    return s
