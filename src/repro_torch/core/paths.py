"""The two ingress paths + the single (paging) egress path (port of
``repro.core.paths``).

The JAX helpers are pure functions whose conditional parts run under
``lax.cond``.  Here every helper updates the state in place and takes an
optional ``do`` mask (a 0-d bool tensor; ``None`` = unconditional): a
masked-off write lands in the target's trash row (see ``state``) instead of
branching on the device value, so no helper ever syncs with the host.
Indices that may be 0-d tensors go through :func:`take`/:func:`put`/
:func:`add`, which index with a 1-element tensor: PyTorch turns a 0-d
integer tensor index into a host integer (a sync).
"""
from __future__ import annotations

import torch

from . import state as st
from .layout import FREE, LOCAL, REMOTE, PlaneConfig

INF32 = 2 ** 31 - 1


# --------------------------------------------------------------------------
# sync-free indexing helpers
# --------------------------------------------------------------------------

def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along axis 0 for an index tensor of any shape (0-d too)."""
    return x[i.reshape(-1)].reshape(tuple(i.shape) + tuple(x.shape[1:]))


def _masked(x: torch.Tensor, i: torch.Tensor, do) -> torch.Tensor:
    i = i.reshape(-1)
    if do is None:
        return i
    return torch.where(do.reshape(-1), i, x.shape[0] - 1)   # trash row


def put(x: torch.Tensor, i: torch.Tensor, val, do=None) -> None:
    """``x[i] = val`` along axis 0, only where ``do`` (else the trash row).
    A Python scalar is made a device scalar first: assigned through
    indexing as it is, PyTorch copies it from the host with a sync."""
    if not isinstance(val, torch.Tensor):
        val = torch.full((), val, dtype=x.dtype, device=x.device)
    x[_masked(x, i, do)] = val


def add(x: torch.Tensor, i: torch.Tensor, delta, do=None) -> None:
    """``x[i] += delta`` along axis 0 (duplicates accumulate), only where
    ``do`` (else the trash row)."""
    i = _masked(x, i, do)
    if isinstance(delta, torch.Tensor):
        src = delta.to(x.dtype).expand((i.shape[0],) + tuple(x.shape[1:]))
    else:
        src = torch.full((i.shape[0],) + tuple(x.shape[1:]), delta,
                         dtype=x.dtype, device=x.device)
    x.index_add_(0, i, src)


def sel(do, new, old):
    """A 0-d field's new value where ``do``, else its old one."""
    return new if do is None else torch.where(do, new, old)


def i32(do):
    """``do`` as an int32 count (1 when unconditional)."""
    return 1 if do is None else do.to(torch.int32)


def _and(a, b):
    return b if a is None else a & b


# --------------------------------------------------------------------------
# profiling primitives (always-on, paper §4.1)
# --------------------------------------------------------------------------

def car_of(cfg: PlaneConfig, s: st.PlaneState, v) -> torch.Tensor:
    """Card access rate of vpage ``v``: set CAT bits / allocated cards."""
    set_bits = take(s.cat, v).sum(dim=-1, dtype=torch.int32)
    denom = take(s.alloc_count, v).clamp_min(1)
    return set_bits.to(torch.float32) / denom.to(torch.float32)


def touch(cfg: PlaneConfig, s: st.PlaneState, v, slot, *, write=False,
          obj_id=None, do=None) -> st.PlaneState:
    """Record an access: CAT card bit, per-object access bit, page recency."""
    P = cfg.page_objs
    put(s.cat.view(-1), v * P + slot, True, do)
    put(s.access.view(-1), v * P + slot, True, do)
    put(s.clock, v, s.step, do)
    if write:
        put(s.dirty, v, True, do)
    if obj_id is not None:
        put(s.obj_last, obj_id, s.step, do)
    return s


def pin_page(s: st.PlaneState, v, do=None) -> st.PlaneState:
    add(s.pin, v, 1, do)
    return s


def unpin_page(s: st.PlaneState, v, do=None) -> st.PlaneState:
    add(s.pin, v, -1, do)
    return s


# --------------------------------------------------------------------------
# egress: page-out (the only egress path, paper §4.1 "Egress")
# --------------------------------------------------------------------------

def page_out_frames(cfg: PlaneConfig, s: st.PlaneState, fr: torch.Tensor,
                    mask: torch.Tensor) -> st.PlaneState:
    """Evict the occupied frames ``fr[mask]`` (distinct) at once: write back
    to the slab, PSF from CAR (EMA blend), CAT clear.  The vectorized form
    of :func:`page_out` over a set of frames, whose pages are disjoint, so
    the result equals evicting them one by one in any order."""
    V = cfg.num_vpages
    frc = fr.clamp_min(0)
    old_v = torch.where(mask, s.vpage_of[frc], -1)
    evict = mask & (old_v >= 0)
    ovs = old_v.clamp_min(0)
    ov = torch.where(evict, old_v, V)            # trash row = no-op
    car_inst = (s.cat[ovs].sum(dim=1, dtype=torch.int32).to(torch.float32)
                / s.alloc_count[ovs].clamp_min(1).to(torch.float32))
    car = torch.maximum(car_inst, s.car_ema[ovs])
    new_psf = car >= s.car_thr
    old_psf = s.psf[ovs]
    flip_p = (evict & ~old_psf & new_psf).sum(dtype=torch.int32)
    flip_r = (evict & old_psf & ~new_psf).sum(dtype=torch.int32)
    n_dirty = (evict & s.dirty[ovs]).sum(dtype=torch.int32)
    s.slab[ov] = s.frames[frc]                   # unconditional write-back
    s.psf[ov] = new_psf
    put(s.cat, ov, False)
    put(s.backing, ov, REMOTE)
    put(s.frame_of, ov, -1)
    put(s.vpage_of, torch.where(evict, fr, cfg.num_frames), -1)
    put(s.dirty, ov, False)
    put(s.prefetched, ov, False)                 # unread prefetch wasted
    st.bump(s.stats, page_outs=evict.sum(dtype=torch.int32),
            dirty_page_outs=n_dirty, psf_to_paging=flip_p,
            psf_to_runtime=flip_r)
    return s


def page_out(cfg: PlaneConfig, s: st.PlaneState, f, do=None
             ) -> st.PlaneState:
    """Evict frame ``f``: write back to the slab, update PSF from CAR,
    clear the CAT.  Must only be called on an unpinned, occupied frame."""
    v = take(s.vpage_of, f)
    car = torch.maximum(car_of(cfg, s, v), take(s.car_ema, v))
    new_psf = car >= s.car_thr
    old_psf = take(s.psf, v)
    flip_to_p = (~old_psf & new_psf).to(torch.int32)
    flip_to_r = (old_psf & ~new_psf).to(torch.int32)
    dirty = take(s.dirty, v).to(torch.int32)
    put(s.slab, v, take(s.frames, f), do)
    put(s.psf, v, new_psf, do)
    put(s.cat, v, False, do)
    put(s.backing, v, REMOTE, do)
    put(s.frame_of, v, -1, do)
    put(s.vpage_of, f, -1, do)
    put(s.dirty, v, False, do)
    put(s.prefetched, v, False, do)
    d = i32(do)
    st.bump(s.stats, page_outs=d, dirty_page_outs=dirty * d,
            psf_to_paging=flip_to_p * d, psf_to_runtime=flip_to_r * d)
    return s


def _victim_frame(cfg: PlaneConfig, s: st.PlaneState):
    """Page-level clock/LRU victim among unpinned occupied frames (O(F)).
    Returns (frame, valid)."""
    v = s.vpage_of[:cfg.num_frames]
    occupied = v >= 0
    vres = v.clamp_min(0)
    pinned = torch.where(occupied, s.pin[vres] > 0, True)
    score = torch.where(occupied & ~pinned, s.clock[vres], INF32)
    f = torch.argmin(score).to(torch.int32)       # first minimum, as JAX
    return f, take(score, f) < INF32


def alloc_frame(cfg: PlaneConfig, s: st.PlaneState, do=None):
    """Return (state, frame): a free frame, evicting a victim if needed."""
    free = s.vpage_of[:cfg.num_frames] < 0
    have_free = free.any()
    f_free = torch.argmax(free.to(torch.int8)).to(torch.int32)
    f_vic, _ = _victim_frame(cfg, s)
    # callers bound the pins per batch, so a victim always exists here
    page_out(cfg, s, f_vic, do=_and(do, ~have_free))
    return s, torch.where(have_free, f_free, f_vic)


# --------------------------------------------------------------------------
# ingress path 1: paging (whole-page fetch; vaddrs stable)
# --------------------------------------------------------------------------

def page_in(cfg: PlaneConfig, s: st.PlaneState, v, do=None
            ) -> st.PlaneState:
    """Fetch vpage ``v`` (REMOTE -> LOCAL) through the paging path, into a
    frame ``alloc_frame`` chooses (evicting its victim if none is free):
    the paper's paging path as one operation."""
    s, f = alloc_frame(cfg, s, do)
    return page_in_at(cfg, s, v, f, do)


def page_in_at(cfg: PlaneConfig, s: st.PlaneState, v, f, do=None
               ) -> st.PlaneState:
    """Fetch vpage ``v`` into the GIVEN (already vacated) frame ``f`` — the
    scalar replay body of a planned paging fetch."""
    put(s.frames, f, take(s.slab, v), do)
    put(s.backing, v, LOCAL, do)
    put(s.frame_of, v, f, do)
    put(s.vpage_of, f, v, do)
    put(s.cat, v, False, do)
    put(s.clock, v, s.step, do)
    st.bump(s.stats, page_ins=i32(do))
    return s


# --------------------------------------------------------------------------
# ingress path 2: runtime object fetch (log-structured; rewrites obj_loc)
# --------------------------------------------------------------------------

def _fresh_vpage(cfg: PlaneConfig, s: st.PlaneState, do=None):
    """Allocate a FREE vpage backed by a fresh frame; returns (state, vpage).
    The new page is pinned (it is an active allocation target)."""
    free_v = s.backing[:cfg.num_vpages] == FREE
    v = torch.argmax(free_v.to(torch.int8)).to(torch.int32)
    s, f = alloc_frame(cfg, s, do)
    put(s.backing, v, LOCAL, do)
    put(s.frame_of, v, f, do)
    put(s.vpage_of, f, v, do)
    put(s.alloc_count, v, 0, do)
    put(s.live_count, v, 0, do)
    put(s.cat, v, False, do)
    put(s.access, v, False, do)
    put(s.obj_of, v, -1, do)
    put(s.dirty, v, True, do)                    # log pages are born dirty
    put(s.clock, v, s.step, do)
    put(s.psf, v, bool(cfg.psf_init_paging), do)
    put(s.car_ema, v, 0.0, do)
    put(s.prefetched, v, False, do)
    return pin_page(s, v, do), v


def _ensure_fill(cfg: PlaneConfig, s: st.PlaneState, which: str, do=None):
    """Make sure the named fill cursor points at a page with a free slot."""
    cur = getattr(s, which)
    full = take(s.alloc_count, cur.clamp_min(0)) >= cfg.page_objs
    need = _and(do, (cur < 0) | full)
    unpin_page(s, cur, do=need & (cur >= 0))     # retire the old fill page
    s, v = _fresh_vpage(cfg, s, do=need)
    setattr(s, which, torch.where(need, v, cur))
    return s


def free_page(cfg: PlaneConfig, s: st.PlaneState, v, do=None
              ) -> st.PlaneState:
    """Release vpage ``v`` (and its frame, if local) back to the allocator."""
    fo = take(s.frame_of, v)
    drop = _and(do, fo >= 0)
    put(s.vpage_of, fo, -1, drop)
    put(s.frame_of, v, -1, drop)
    put(s.backing, v, FREE, do)
    put(s.dirty, v, False, do)
    put(s.prefetched, v, False, do)
    return s


def _kill_old_copy(cfg: PlaneConfig, s: st.PlaneState, v_old, slot_old,
                   do=None) -> st.PlaneState:
    """Mark an object's previous slot dead; GC the page if it just emptied."""
    put(s.obj_of.view(-1), v_old * cfg.page_objs + slot_old, -1, do)
    add(s.live_count, v_old, -1, do)
    dead = (take(s.live_count, v_old) == 0) & (take(s.pin, v_old) == 0)
    return free_page(cfg, s, v_old, do=_and(do, dead))


def _append_obj(cfg: PlaneConfig, s: st.PlaneState, o, row, which: str,
                do=None):
    """Append object ``o`` (data ``row``) to the named fill page; rewrites the
    smart pointer and kills the old copy."""
    P, D = cfg.page_objs, cfg.obj_dim
    s = _ensure_fill(cfg, s, which, do)
    v_new = getattr(s, which)
    slot_new = take(s.alloc_count, v_new)
    f_new = take(s.frame_of, v_new)
    old = take(s.obj_loc, o)
    v_old, slot_old = old // P, old % P
    put(s.frames.view(-1, D), f_new * P + slot_new, row, do)
    put(s.obj_loc, o, v_new * P + slot_new, do)
    put(s.obj_of.view(-1), v_new * P + slot_new, o, do)
    add(s.alloc_count, v_new, 1, do)
    add(s.live_count, v_new, 1, do)
    s = _kill_old_copy(cfg, s, v_old, slot_old, do)
    return s, v_new, slot_new


def object_in(cfg: PlaneConfig, s: st.PlaneState, o, do=None
              ) -> st.PlaneState:
    """Fetch object ``o`` through the runtime path: its row from the far
    tier onto the ingress fill page (a new fill page when the current one
    is full), the smart pointer rewritten, the old copy killed, its card
    bit set: the runtime path as one operation."""
    P, D = cfg.page_objs, cfg.obj_dim
    row = take(s.slab.view(-1, D), take(s.obj_loc, o))
    s, v_new, slot_new = _append_obj(cfg, s, o, row, "fill_vpage", do)
    st.bump(s.stats, obj_ins=i32(do))
    put(s.cat.view(-1), v_new * P + slot_new, True, do)
    return s
