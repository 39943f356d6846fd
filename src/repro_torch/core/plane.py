"""The Atlas hybrid data plane: batched access, evacuation, epochs,
writeback (port of ``repro.core.plane``).

``access``/``update`` are the batched read/write barriers served by the
plan-then-execute engine in :mod:`repro_torch.core.batch`.
``advance_epoch`` folds the card table into the per-page CAR EMA through
the ``cat_decay`` kernel and lets the governor move the PSF threshold.
``evacuate`` is the compactor: victims chosen by garbage ratio, live rows
re-packed hot/cold through the ``compact_pages`` kernel.

Every function updates the state in place and returns it (the JAX
functions return a new state); ``PlaneState.clone`` gives an independent
copy.  Nothing here syncs with the host except ``check_invariants``, whose
result is host booleans.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops as kops
from . import batch as batch_lib
from . import paths
from . import state as st
from . import trace
from .layout import CAR_THR_MAX, CAR_THR_MIN, FREE, LOCAL, PlaneConfig
from .paths import add, put, take

I32 = torch.int32


# --------------------------------------------------------------------------
# batched access (the hybrid ingress) — plan-then-execute engine
# --------------------------------------------------------------------------

def access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor, *,
           mode: str | None = None):
    """Batched hybrid access.  ``obj_ids`` is ``[R]`` int32 (negative =
    padded no-op); returns ``(state, rows[R, D])``.  ``mode="batch"`` and
    ``mode="reference"`` agree bit for bit."""
    return batch_lib.access(cfg, s, obj_ids, mode=mode)


def update(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
           rows: torch.Tensor, *, mode: str | None = None) -> st.PlaneState:
    """Batched write-through-local: fault in, overwrite rows, mark dirty."""
    return batch_lib.update(cfg, s, obj_ids, rows, mode=mode)


# --------------------------------------------------------------------------
# epoch governor (always-on profiling, adaptive path selection)
# --------------------------------------------------------------------------

def advance_epoch(cfg: PlaneConfig, s: st.PlaneState, *,
                  traffic=None) -> st.PlaneState:
    """Close one profiling epoch: fold the card table into the per-page CAR
    EMA (``cat_decay`` kernel), move the PSF threshold by
    ``governor_gain * (d_page - d_obj) / total`` (clipped to
    [CAR_THR_MIN, CAR_THR_MAX]), recompute every allocated page's PSF from
    the decayed CAR, and clear the card table.  ``traffic`` optionally
    overrides the ``(d_page, d_obj)`` f32 byte deltas."""
    V = cfg.num_vpages
    allocated = s.backing[:V] != FREE
    ema = kops.cat_decay(s.cat[:V], s.car_ema[:V], s.alloc_count[:V],
                         decay=cfg.car_decay, impl=cfg.kernel_impl)
    ema = torch.where(allocated, ema, 0.0)

    if traffic is None:
        d_page = ((s.stats.page_ins - s.epoch_page_ins).to(torch.float32)
                  * cfg.page_bytes)
        d_obj = ((s.stats.obj_ins - s.epoch_obj_ins).to(torch.float32)
                 * cfg.row_bytes)
    else:
        d_page, d_obj = traffic
    total = d_page + d_obj
    imbalance = torch.where(total > 0.0,
                            (d_page - d_obj) / total.clamp_min(1.0), 0.0)
    gain = torch.full((), cfg.governor_gain, dtype=torch.float32,
                      device=s.device)
    thr = (s.car_thr + gain * imbalance).clamp(CAR_THR_MIN, CAR_THR_MAX)

    psf = s.psf[:V]
    new_psf = torch.where(allocated, ema >= thr, psf)
    flip_p = (allocated & ~psf & new_psf).sum(dtype=I32)
    flip_r = (allocated & psf & ~new_psf).sum(dtype=I32)
    s.cat.fill_(False)                    # open the next epoch window
    s.car_ema[:V] = ema
    s.car_thr = thr
    psf.copy_(new_psf)
    s.epoch = s.epoch + 1
    s.epoch_page_ins = s.stats.page_ins.clone()
    s.epoch_obj_ins = s.stats.obj_ins.clone()
    st.bump(s.stats, epochs=1, psf_to_paging=flip_p, psf_to_runtime=flip_r)
    return s


# --------------------------------------------------------------------------
# evacuation (concurrent compactor analogue, paper §4.3)
# --------------------------------------------------------------------------

class EvacPlan(NamedTuple):
    """Victim selection for one evacuation slice (fixed ``[k]`` shapes)."""

    victims: torch.Tensor   # [k] int32 candidate vpages (garbage-ratio top-k)
    ok: torch.Tensor        # [k] bool  candidate was eligible at plan time


def plan_evacuate(cfg: PlaneConfig, s: st.PlaneState,
                  garbage_threshold: float | None = None,
                  max_pages: int = 16) -> EvacPlan:
    """Select at most ``max_pages`` evacuation victims: the local, unpinned
    pages with the highest dead-slot ratio above the threshold (ties to the
    lowest vpage, as ``lax.top_k``)."""
    V = cfg.num_vpages
    thr = (cfg.evac_garbage_threshold if garbage_threshold is None
           else garbage_threshold)
    allocated = s.alloc_count[:V]
    dead = allocated - s.live_count[:V]
    ratio = dead.to(torch.float32) / allocated.clamp_min(1).to(torch.float32)
    eligible = ((s.backing[:V] == LOCAL) & (s.pin[:V] == 0) & (allocated > 0)
                & (ratio > thr))
    score = torch.where(eligible, ratio, -1.0)
    k = min(max_pages, V)
    vals, order = batch_lib.stable_order(score, descending=True)
    return EvacPlan(victims=order[:k], ok=vals[:k] > -1.0)


def last_writes(idx: torch.Tensor, trash: int) -> torch.Tensor:
    """``idx [n]`` with every write but the last to each index sent to
    ``trash``.  JAX applies duplicate scatter writes in order, so the last
    one wins; CUDA's ``index_put`` leaves them unordered."""
    i = torch.arange(idx.shape[0], device=idx.device)
    last = torch.where(idx[None, :] == idx[:, None], i[None, :],
                       -1).amax(dim=1) == i
    return torch.where(last, idx, trash)


def _evacuate_page(cfg: PlaneConfig, s: st.PlaneState, v: torch.Tensor,
                   do: torch.Tensor) -> st.PlaneState:
    """Compact victim page ``v`` where ``do`` holds: hot/cold append
    streams, ``compact_pages`` assembly of the (up to four) destination
    pages, smart-pointer rewrite, and GC of the drained source."""
    P, V, F, O, D = (cfg.page_objs, cfg.num_vpages, cfg.num_frames,
                     cfg.num_objs, cfg.obj_dim)
    # pin the source so destination allocation can't page it out from under
    # the compactor (Invariant #3 mechanism)
    paths.pin_page(s, v, do)
    f_src = take(s.frame_of, v).clamp_min(0)
    objs = take(s.obj_of, v)                      # [P]
    occ = objs >= 0
    acc = take(s.access, v)
    hotm = occ & acc
    coldm = occ & ~acc
    was_carded = take(s.cat, v)
    n_moved = occ.sum(dtype=I32)

    s, hv, hslot, hcur, hc, hf, hret = batch_lib.plan_append_stream(
        cfg, s, "evac_hot_vpage", hotm, do)
    s, cv, cslot, ccur, cc, cf, cret = batch_lib.plan_append_stream(
        cfg, s, "evac_cold_vpage", coldm, do)
    v_dst = torch.where(hotm, hv, cv)
    s_dst = torch.where(hotm, hslot, cslot)

    # assemble the destination pages with the compact kernel: each slot
    # copies its source row directly; row 4 of the plan is the trash row
    src_flat = f_src * P + torch.arange(P, dtype=I32, device=s.device)
    dest_pages = torch.stack([hc, hf, cc, cf])    # [4]
    dpi = torch.where(hotm, torch.where(hcur, 0, 1),
                      torch.where(coldm, torch.where(ccur, 2, 3), 4))
    plan = torch.full((5, P), -1, dtype=I32, device=s.device)
    plan[dpi, torch.where(occ, s_dst, 0)] = src_flat
    plan = plan[:4]
    frame_rows = s.frames.view(-1, D)
    assembled = kops.compact_pages(frame_rows, plan.reshape(4 * P),
                                   page_objs=P, impl=cfg.kernel_impl)
    dest_f = s.frame_of[dest_pages.clamp_min(0)].clamp_min(0)
    merged = torch.where((plan >= 0)[..., None], assembled, s.frames[dest_f])
    # two destinations can share a frame when one of the pages has none
    # (it reads as frame 0), as in a plane of 4 frames
    s.frames[last_writes(torch.where((dest_pages >= 0) & do, dest_f, F),
                         F)] = merged

    # smart pointers + occupancy + preserved profiling bits
    moved = occ & do
    dst = v_dst * P + s_dst
    dst_flat = torch.where(moved, dst, V * P)
    s.obj_loc[torch.where(moved, objs, O)] = dst
    s.obj_of.view(-1)[dst_flat] = objs
    s.cat.view(-1)[dst_flat] = was_carded
    s.access.view(-1)[dst_flat] = hotm
    st.bump(s.stats, evac_moved=n_moved * do.to(I32))
    # the moved rows are in place: now the retired cursors may unpin
    add(s.pin, hret, -1, do & (hret >= 0))
    add(s.pin, cret, -1, do & (cret >= 0))
    # kill the source copies wholesale
    put(s.obj_of, v, -1, do)
    put(s.live_count, v, 0, do)
    paths.unpin_page(s, v, do)
    # the pin kept GC away; reclaim the drained source explicitly
    still_here = take(s.backing, v) == LOCAL
    paths.free_page(cfg, s, v,
                    do & still_here & (take(s.live_count, v) == 0))
    st.bump(s.stats, evac_pages=do.to(I32))
    return s


def execute_evacuate(cfg: PlaneConfig, s: st.PlaneState, plan: EvacPlan,
                     garbage_threshold: float | None = None, *,
                     clear_access: bool = True, shard=None) -> st.PlaneState:
    """Compact the planned victim pages.  Each victim's eligibility is
    re-checked against the current state (a stale entry is skipped), and
    an egress fault skips a victim whole.  ``k`` victims are a static trip
    count: a skipped victim's updates are masked, not branched around."""
    thr = (cfg.evac_garbage_threshold if garbage_threshold is None
           else garbage_threshold)
    fc = cfg.faults
    shard_i = 0 if shard is None else shard
    for i in range(plan.victims.shape[0]):
        with trace.span("engine.evacuate.page"):
            v = plan.victims[i]
            allocated = take(s.alloc_count, v)
            dead = allocated - take(s.live_count, v)
            ratio = dead.to(torch.float32) / allocated.clamp_min(1).to(
                torch.float32)
            selected = (plan.ok[i] & (take(s.backing, v) == LOCAL)
                        & (take(s.pin, v) == 0) & (allocated > 0)
                        & (ratio > thr))
            if fc is not None and fc.egress_active:
                efail = fc.egress_fail(s.step, v, shard_i)
                st.bump(s.stats, egress_failures=(selected & efail).to(I32))
                selected = selected & ~efail
            _evacuate_page(cfg, s, v, selected)
    if clear_access:
        s.access.fill_(False)
    return s


def evacuate(cfg: PlaneConfig, s: st.PlaneState,
             garbage_threshold: float | None = None,
             max_pages: int = 16, *,
             clear_access: bool = True, shard=None) -> st.PlaneState:
    """Foreground evacuation: plan + execute in one call."""
    with trace.span("engine.evacuate.plan"):
        plan = plan_evacuate(cfg, s, garbage_threshold, max_pages)
    return execute_evacuate(cfg, s, plan, garbage_threshold,
                            clear_access=clear_access, shard=shard)


# --------------------------------------------------------------------------
# maintenance / introspection
# --------------------------------------------------------------------------

def writeback_all(cfg: PlaneConfig, s: st.PlaneState) -> st.PlaneState:
    """Flush every dirty local page to the slab (keeps pages resident)."""
    F, V = cfg.num_frames, cfg.num_vpages
    vpo = s.vpage_of[:F]
    flush = (vpo >= 0) & s.dirty[vpo.clamp_min(0)]
    vm = torch.where(flush, vpo, V)
    s.slab[vm] = s.frames[:F]
    put(s.dirty, vm, False)
    return s


def evict_all(cfg: PlaneConfig, s: st.PlaneState) -> st.PlaneState:
    """Page out every unpinned local page (shutdown / memory-pressure)."""
    F = cfg.num_frames
    vpo = s.vpage_of[:F]
    can = (vpo >= 0) & (s.pin[vpo.clamp_min(0)] == 0)
    return paths.page_out_frames(
        cfg, s, torch.arange(F, dtype=I32, device=s.device), can)


def peek(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor
         ) -> torch.Tensor:
    """Read object rows wherever they live, with NO state change (oracle)."""
    vaddr = s.obj_loc[obj_ids]
    v, slot = vaddr // cfg.page_objs, vaddr % cfg.page_objs
    local = s.backing[v] == LOCAL
    f = s.frame_of[v].clamp_min(0)
    return torch.where(local[:, None], s.frames[f, slot], s.slab[v, slot])


def occupancy(cfg: PlaneConfig, s: st.PlaneState) -> torch.Tensor:
    """Fraction of local frames in use."""
    return (s.vpage_of[:cfg.num_frames] >= 0).to(torch.float32).mean()


def paging_fraction(cfg: PlaneConfig, s: st.PlaneState) -> torch.Tensor:
    """Fraction of allocated pages whose PSF is paging (paper Fig. 7)."""
    V = cfg.num_vpages
    allocated = s.backing[:V] != FREE
    pg = (s.psf[:V] & allocated).sum(dtype=I32)
    return pg / allocated.sum(dtype=I32).clamp_min(1)


def check_invariants(cfg: PlaneConfig, s: st.PlaneState) -> dict:
    """Structural invariants, vectorized on the state's device (the JAX
    version loops over every object and page in Python).  Returns the same
    dict of host booleans."""
    P, V, F, O = cfg.page_objs, cfg.num_vpages, cfg.num_frames, cfg.num_objs
    obj_loc, obj_of = s.obj_loc[:O], s.obj_of[:V]
    backing, frame_of, vpage_of = s.backing[:V], s.frame_of[:V], s.vpage_of[:F]
    live_count, alloc_count, pin = (s.live_count[:V], s.alloc_count[:V],
                                    s.pin[:V])
    out = {}
    # smart pointers and slot occupancy agree
    placed = obj_loc >= 0
    occupant = obj_of.reshape(-1)[obj_loc.clamp(0, V * P - 1)]
    ids = torch.arange(O, dtype=I32, device=s.device)
    out["obj_loc_obj_of_consistent"] = ~placed | ((obj_loc < V * P)
                                                  & (occupant == ids))
    live = (obj_of >= 0).sum(dim=1, dtype=I32)
    out["live_count_correct"] = live == live_count
    out["alloc_ge_live"] = alloc_count >= live_count
    # frame table is a bijection on LOCAL pages
    is_local = backing == LOCAL
    fo = frame_of.clamp(0, F - 1)
    vids = torch.arange(V, dtype=I32, device=s.device)
    fwd = torch.where(is_local,
                      (frame_of >= 0) & (frame_of < F) & (vpage_of[fo] == vids),
                      frame_of == -1)
    occ = vpage_of >= 0
    vo = vpage_of.clamp(0, V - 1)
    fids = torch.arange(F, dtype=I32, device=s.device)
    inv = ~occ | ((vpage_of < V) & (backing[vo] == LOCAL)
                  & (frame_of[vo] == fids))
    out["frame_bijection"] = torch.stack([fwd.all(), inv.all()])
    out["pins_nonnegative"] = pin >= 0
    # outside an access batch the only standing pins are the fill cursors
    expected = torch.zeros((V + 1,), dtype=I32, device=s.device)
    cursors = torch.stack([s.fill_vpage, s.evac_hot_vpage,
                           s.evac_cold_vpage, s.remote_fill_vpage])
    add(expected, torch.where(cursors >= 0, cursors, V), 1)
    out["pins_are_cursor_pins"] = pin == expected[:V]
    out["free_pages_empty"] = (backing != FREE) | (live_count == 0)
    flags = torch.stack([t.all() for t in out.values()]).cpu().tolist()
    return {k: bool(b) for k, b in zip(out, flags)}
