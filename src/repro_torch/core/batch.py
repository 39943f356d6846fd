"""Plan-then-execute batch ingress engine (port of ``repro.core.batch``).

1. **Plan** (vectorized over the batch): classify each request hit/miss
   against the batch-entry state, split misses by the page's PSF, dedup
   (paging misses per page, runtime misses per object) in first-appearance
   order, grow the prefetch-candidate section, and pair every planned
   page-in with a victim frame in one stable sort over the frame pool.
2. **Execute**: the paging plan as masked scatters plus ONE
   ``kernels.ops.gather_rows_into`` call (slab pages straight into their
   frames); the runtime plan with prefix arithmetic over the fill cursor
   plus ONE ``gather_rows_into`` call (slab rows straight into their
   frame slots).  JAX gathers, then scatters; each row lands the same.
3. **Finish**: one profiling scatter pass and one batched gather per tier.

Under a recording profiler the plan's blocks and the execute's calls run
under ``core.trace`` spans (``engine.plan.*``, ``engine.execute.*``).

Batch semantics are those of the JAX engine (DESIGN.md §3): a negative id
is a padded no-op request whose scatters land in the trash rows.
``mode="reference"`` replays the same plan through the scalar helpers of
``paths``, one state update per moved row or touched card: the oracle the
batched executor is held to, bit for bit.

Where JAX and PyTorch differ, this port reproduces JAX on purpose:
``lax.top_k`` ties go to the lowest index (a stable sort here); an
out-of-bounds scatter is dropped (a trash row here); an out-of-range
gather is clamped (every gather index here is in range by construction);
and ``lax.cond``/``fori_loop`` over device values become masked updates
with static trip counts, so nothing on this path syncs with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops as kops
from . import paths
from . import state as st
from . import trace
from .layout import FREE, LOCAL, REMOTE, PlaneConfig
from .paths import INF32, add, put, take

I32 = torch.int32


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def _cumsum(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.to(I32), 0, dtype=I32)


# --------------------------------------------------------------------------
# planning primitives (vectorized dedup / classification)
# --------------------------------------------------------------------------

def _first_of(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First-appearance flags: ``out[i]`` iff ``mask[i]`` and no ``j < i``
    has ``mask[j] and keys[j] == keys[i]``.  O(R^2) compare."""
    R = keys.shape[0]
    i = _arange(R, keys)
    same = (keys[None, :] == keys[:, None]) & mask[None, :]
    first_j = torch.where(same, i[None, :], R).amin(dim=1)
    return mask & (first_j == i)


def _compact(keys: torch.Tensor, first: torch.Tensor):
    """Pack the flagged keys to the front (first-appearance order).
    Returns (plan [R] int32 with -1 padding, count)."""
    R = keys.shape[0]
    pos = _cumsum(first) - 1
    plan = torch.full((R + 1,), -1, dtype=I32, device=keys.device)
    plan[torch.where(first, pos, R)] = keys      # slot R = trash
    return plan[:R], _count(first)


def majority_stride(d: torch.Tensor, n_d: torch.Tensor):
    """Leap-style majority vote over the first ``n_d`` deltas of ``d``:
    the dominant delta if it has an absolute majority, else the most
    recent delta.  Returns ``(stride, have)``."""
    N = d.shape[0]
    dvalid = _arange(N, d) < n_d
    same = (d[None, :] == d[:, None]) & dvalid[None, :]
    counts = torch.where(dvalid, same.sum(dim=1, dtype=I32), 0)
    best = torch.argmax(counts).to(I32)          # first maximum, as JAX
    majority = take(counts, best) * 2 > n_d
    last = take(d, (n_d - 1).clamp(0, N - 1))
    stride = torch.where(majority, take(d, best), last)
    return stride, (n_d >= 1) & (stride != 0)


def stable_order(score: torch.Tensor, descending: bool = False):
    """Indices of ``score`` sorted, ties by lowest index: the order of
    ``lax.top_k`` (``torch.topk`` leaves tie order unspecified)."""
    vals, order = torch.sort(score, descending=descending, stable=True)
    return vals, order.to(I32)


class AccessPlan(NamedTuple):
    """Fixed-shape description of one batch's ingress work (fields as in
    the JAX ``AccessPlan``)."""

    vpage: torch.Tensor      # [R] entry vpages (V for padded ids)
    page_plan: torch.Tensor  # [R] deduped paging-miss pages (-1 pad)
    n_pages: torch.Tensor    # []
    obj_plan: torch.Tensor   # [R] deduped runtime-miss objects (-1 pad)
    n_objs: torch.Tensor     # []
    pg_fetch: torch.Tensor   # [R+Q] scheduled page-ins, demand++prefetch (-1)
    pg_victim: torch.Tensor  # [R+Q] destination frame per scheduled fetch
    pg_is_pf: torch.Tensor   # [R+Q] bool: entry belongs to the prefetch section
    served: torch.Tensor     # [R] bool: request's row is ground truth this tick
    n_miss: torch.Tensor     # [] classified misses (pre-fault)
    n_failed: torch.Tensor   # [] planned fetches masked off by the fault model
    n_egress: torch.Tensor   # [] remote writes blocked by the fault model


def _prefetch_candidates(cfg: PlaneConfig, s: st.PlaneState,
                         page_plan: torch.Tensor, n_pages: torch.Tensor,
                         *, use_psf: bool) -> torch.Tensor:
    """The prefetch-candidate section of the paging plan: ``[Q]`` pages (-1
    pad), deduped, bounds/backing checked, PSF-masked (hybrid only) and
    disjoint from the demand plan."""
    V, Q, R = cfg.num_vpages, cfg.prefetch_budget, page_plan.shape[0]
    none = torch.full((Q,), -1, dtype=I32, device=page_plan.device)
    if cfg.prefetch == "sequential":
        if cfg.readahead <= 0:
            return none
        off = torch.arange(1, cfg.readahead + 1, dtype=I32,
                           device=page_plan.device)
        cand = torch.where(page_plan[:, None] >= 0,
                           page_plan[:, None] + off[None, :], -1).reshape(-1)
    else:  # "majority"
        if R < 2:
            return none
        stride, have = majority_stride(page_plan[1:] - page_plan[:-1],
                                       (n_pages - 1).clamp_min(0))
        base = take(page_plan, (n_pages - 1).clamp(0, R - 1))
        k = torch.arange(1, Q + 1, dtype=I32, device=page_plan.device)
        cand = torch.where(have, base + k * stride, -1)
    ok = (cand >= 0) & (cand < V)
    safe = cand.clamp(0, V - 1)
    ok &= s.backing[safe] == REMOTE          # allocated and currently far
    if use_psf:
        ok &= s.psf[safe]                    # only paging-path pages
    ok &= ~(cand[:, None] == page_plan[None, :]).any(dim=1)
    cand = torch.where(ok, cand, -1)
    plan, _ = _compact(cand, _first_of(cand, ok))
    return plan[:Q]


def _frame_order(cfg: PlaneConfig, s: st.PlaneState, target=None):
    """Frames in eviction-preference order (stable, ties by index): free
    frames first, then unpinned occupied frames by clock; with ``target``
    ([V+1] bool) frames holding a target page rank just before pinned
    frames, which rank last.  Returns (sorted scores, frame order)."""
    vpo = s.vpage_of[:cfg.num_frames]
    occ = vpo >= 0
    vres = vpo.clamp_min(0)
    pinned = occ & (s.pin[vres] > 0)
    score = s.clock[vres]
    if target is not None:
        score = torch.where(occ & target[vres], INF32 - 1, score)
    score = torch.where(~occ, -INF32, torch.where(pinned, INF32, score))
    return stable_order(score)


def _plan_victims(cfg: PlaneConfig, s: st.PlaneState, req_v: torch.Tensor,
                  fetch: torch.Tensor, is_pf: torch.Tensor):
    """Pair every scheduled fetch with a destination frame: free frames
    first (index order), then the coldest unpinned occupied frames; frames
    holding this batch's target pages only under extreme pressure and
    never for a prefetch; pinned frames never.  Fetches beyond the usable
    pool are dropped (-1)."""
    F, V = cfg.num_frames, cfg.num_vpages
    N = fetch.shape[0]
    target = torch.zeros((V + 1,), dtype=torch.bool, device=fetch.device)
    put(target, req_v, True)                      # V (padded) = trash
    vic_score, victims = _frame_order(cfg, s, target)
    k = min(N, F)
    vic_score, victims = vic_score[:k], victims[:k]
    ok = fetch >= 0
    rank = _cumsum(ok) - 1
    r = rank.clamp(0, k - 1)
    vs = vic_score[r]
    usable = ok & (rank < k) & (vs < INF32) & (~is_pf | (vs < INF32 - 1))
    return (torch.where(usable, fetch, -1),
            torch.where(usable, victims[r], -1))


def plan_access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                *, split_by_psf: bool = True, all_runtime: bool = False,
                degraded=False, for_update: bool = False,
                shard=None) -> AccessPlan:
    """Classify the batch and build the two ingress plans (plus the paging
    plan's prefetch section and victim assignment).  ``obj_ids`` is ``[R]``
    int32 (negative = padded no-op).  Reads the state, never writes it.
    The knobs (baselines, fault masking, ``degraded``, ``for_update``) are
    those of the JAX ``plan_access``."""
    R = obj_ids.shape[0]
    Q = cfg.prefetch_budget
    V, P = cfg.num_vpages, cfg.page_objs
    dev = obj_ids.device
    with trace.span("engine.plan.classify"):
        valid = obj_ids >= 0
        vaddr = s.obj_loc[obj_ids.clamp_min(0)]
        v = vaddr // P
        local = s.backing[v] == LOCAL
        if all_runtime:
            pg_mask = torch.zeros_like(local)
            rt_mask = valid & ~local
        elif split_by_psf:
            psf = s.psf[v]
            pg_mask = valid & ~local & psf
            rt_mask = valid & ~local & ~psf
        else:
            pg_mask = valid & ~local
            rt_mask = torch.zeros_like(local)
        v = torch.where(valid, v, V)
    with trace.span("engine.plan.paging"):
        page_plan, n_pages = _compact(v, _first_of(v, pg_mask))
        if all_runtime:
            pf_plan = torch.full((Q,), -1, dtype=I32, device=dev)
        else:
            pf_plan = _prefetch_candidates(cfg, s, page_plan, n_pages,
                                           use_psf=split_by_psf)
    with trace.span("engine.plan.runtime"):
        obj_plan, n_objs = _compact(obj_ids, _first_of(obj_ids, rt_mask))
        # capacity governor for the runtime plan: every fresh-page
        # allocation must still find an unpinned victim (excess misses
        # stay remote)
        F = cfg.num_frames
        vpo = s.vpage_of[:F]
        pinned_frames = _count((vpo >= 0) & (s.pin[vpo.clamp_min(0)] > 0))
        fill = s.fill_vpage
        free_slots = torch.where(
            fill >= 0, P - take(s.alloc_count, fill.clamp_min(0)), 0)
        cap = free_slots + P * (F - pinned_frames).clamp_min(0)
        n_objs = torch.minimum(n_objs, cap)
        obj_plan = torch.where(_arange(R, obj_ids) < n_objs, obj_plan, -1)
    n_miss = n_pages + n_objs
    served = valid
    zero = torch.zeros((), dtype=I32, device=dev)
    n_failed = zero
    n_egress = zero
    fc = cfg.faults
    tick = s.step + 1                        # the step this batch executes at
    shard_i = 0 if shard is None else shard
    static_deg = isinstance(degraded, bool)
    if static_deg and degraded:
        # circuit-breaker mode: no remote fetch at all, local hits only
        page_plan = torch.full((R,), -1, dtype=I32, device=dev)
        n_pages = zero
        obj_plan = torch.full((R,), -1, dtype=I32, device=dev)
        n_objs = zero
        pf_plan = torch.full((Q,), -1, dtype=I32, device=dev)
        served = valid & local
        egress_on = False
    else:
        if fc is not None and fc.active:
            failp = (page_plan >= 0) & fc.fetch_fail(tick, page_plan, shard_i)
            n_failed_p = _count(failp)
            page_plan = torch.where(failp, -1, page_plan)
            n_pages = n_pages - n_failed_p
            failq = (pf_plan >= 0) & fc.fetch_fail(tick, pf_plan, shard_i)
            pf_plan = torch.where(failq, -1, pf_plan)
            # runtime plan: mask, then re-compact (append slots are
            # assigned positionally, so holes are not allowed)
            v_obj = s.obj_loc[obj_plan.clamp_min(0)] // P
            failo = (obj_plan >= 0) & fc.fetch_fail(tick, v_obj, shard_i)
            n_failed_o = _count(failo)
            keep = (obj_plan >= 0) & ~failo
            obj_plan, n_objs = _compact(torch.where(keep, obj_plan, -1), keep)
            served = valid & (local | ~fc.fetch_fail(tick, v, shard_i))
            n_failed = n_failed_p + n_failed_o
        if not static_deg:
            # traced breaker flag: where-overrides, bit-identical per shard
            deg = torch.as_tensor(degraded, device=dev).to(torch.bool)
            page_plan = torch.where(deg, -1, page_plan)
            n_pages = torch.where(deg, 0, n_pages)
            obj_plan = torch.where(deg, -1, obj_plan)
            n_objs = torch.where(deg, 0, n_objs)
            pf_plan = torch.where(deg, -1, pf_plan)
            served = torch.where(deg, valid & local, served)
            n_failed = torch.where(deg, 0, n_failed)
        egress_on = fc is not None and fc.egress_active
    with trace.span("engine.plan.paging"):
        fetch = torch.cat([page_plan, pf_plan])
        is_pf = torch.cat([torch.zeros((R,), dtype=torch.bool, device=dev),
                           torch.ones((Q,), dtype=torch.bool, device=dev)])
        fetch, victim = _plan_victims(cfg, s, v, fetch, is_pf)
    if egress_on:
        # a scheduled page-in whose victim's writeback would fault is
        # dropped whole (keyed by the occupant vpage)
        old_v = s.vpage_of[victim.clamp_min(0)]
        evicting = (victim >= 0) & (old_v >= 0)
        efail = evicting & fc.egress_fail(tick, old_v.clamp_min(0), shard_i)
        n_egress = _count(efail & ~is_pf)
        fetch = torch.where(efail, -1, fetch)
        victim = torch.where(efail, -1, victim)
        if for_update:
            will_local = local | ((fetch[None, :] == v[:, None])
                                  & (victim[None, :] >= 0)).any(dim=1)
            moved = ((obj_plan[None, :] == obj_ids[:, None])
                     & (obj_plan[None, :] >= 0)).any(dim=1)
            wfail = (served & ~will_local & ~moved
                     & fc.egress_fail(tick, v, shard_i))
            served = served & ~wfail
            n_egress = n_egress + _count(wfail)
    return AccessPlan(v, page_plan, n_pages, obj_plan, n_objs, fetch, victim,
                      is_pf, served, n_miss, n_failed, n_egress)


# --------------------------------------------------------------------------
# execution: paging plan
# --------------------------------------------------------------------------

def _exec_paging(cfg: PlaneConfig, s: st.PlaneState, plan: AccessPlan, *,
                 scalar: bool) -> st.PlaneState:
    """Execute the planned page-ins (demand + prefetch).  Batched: every
    page-out as masked scatters, every page-in in ONE
    ``gather_rows_into`` call (safe: victims are distinct frames, evicted
    pages are resident, fetched pages remote).  Scalar: the same plan one
    fetch at a time."""
    V, F = cfg.num_vpages, cfg.num_frames
    fetch, vic, is_pf = plan.pg_fetch, plan.pg_victim, plan.pg_is_pf
    ok = fetch >= 0

    if scalar:
        for j in range(fetch.shape[0]):
            do, f = ok[j], vic[j]
            occupied = take(s.vpage_of, f.clamp_min(0)) >= 0
            paths.page_out(cfg, s, f, do=do & occupied)
            paths.page_in_at(cfg, s, fetch[j], f, do=do)
            mark = do & is_pf[j]
            put(s.prefetched, fetch[j], True, mark)
            st.bump(s.stats, prefetch_issued=mark.to(I32))
        return s

    paths.page_out_frames(cfg, s, vic, ok)
    # ---- page-in: ONE gather from the slab's page view straight into the
    # frames (a masked fetch writes zeros into the trash frame F)
    vin = torch.where(ok, fetch, V)
    fdst = torch.where(ok, vic, F)
    P, D = cfg.page_objs, cfg.obj_dim
    kops.gather_rows_into(s.frames.view(F + 1, P * D), fdst,
                          s.slab.view(-1, P * D), torch.where(ok, fetch, -1),
                          impl=cfg.kernel_impl)
    put(s.backing, vin, LOCAL)
    s.frame_of[vin] = vic
    s.vpage_of[fdst] = torch.where(ok, fetch, -1)
    put(s.cat, vin, False)
    s.clock[vin] = s.step
    s.prefetched[vin] = is_pf
    st.bump(s.stats, page_ins=_count(ok), prefetch_issued=_count(ok & is_pf))
    return s


def _account_prefetch_hits(cfg: PlaneConfig, s: st.PlaneState,
                           plan: AccessPlan) -> st.PlaneState:
    """A demand access to a page whose ``prefetched`` bit stands turned a
    would-be miss into a hit (against batch-entry state)."""
    V = cfg.num_vpages
    used = torch.zeros((V + 1,), dtype=torch.bool, device=s.device)
    put(used, plan.vpage, True)
    used = used[:V] & s.prefetched[:V]
    s.prefetched[:V] &= ~used
    st.bump(s.stats, prefetch_used=_count(used))
    return s


# --------------------------------------------------------------------------
# execution: runtime plan
# --------------------------------------------------------------------------

def _fresh_vpages(cfg: PlaneConfig, s: st.PlaneState, n: torch.Tensor,
                  maxf: int) -> torch.Tensor:
    """Allocate ``n`` (<= ``maxf``) fresh log pages at once; returns the
    ``[maxf]`` vpage list (-1 past ``n``).  Equal to ``n`` sequential
    ``paths._fresh_vpage`` calls: those take the FREE vpages in index order,
    and frames in one fixed order (free frames by index, then unpinned
    occupied frames by clock), since each allocated page is pinned and so
    never a later victim; the evicted pages are disjoint from the fresh
    ones.  ``plan_access`` caps the moves so a victim always exists."""
    V, F = cfg.num_vpages, cfg.num_frames
    j = _arange(maxf, s.backing)
    alloc = j < n
    free_cs = _cumsum(s.backing[:V] == FREE)
    vpos = torch.searchsorted(free_cs, j + 1).to(I32)   # (j+1)-th FREE vpage
    fresh = torch.where(alloc & (vpos < V), vpos, -1)
    _, order = _frame_order(cfg, s)
    f = order[j.clamp(max=F - 1)]
    paths.page_out_frames(cfg, s, f, alloc)          # occupied victims only
    vm = torch.where(alloc, fresh, V)
    put(s.backing, vm, LOCAL)
    s.frame_of[vm] = f
    s.vpage_of[torch.where(alloc, f, F)] = fresh
    for name, val in (("alloc_count", 0), ("live_count", 0), ("cat", False),
                      ("access", False), ("obj_of", -1),
                      ("dirty", True),           # log pages are born dirty
                      ("psf", bool(cfg.psf_init_paging)), ("car_ema", 0.0),
                      ("prefetched", False)):
        put(getattr(s, name), vm, val)
    s.clock[vm] = s.step
    add(s.pin, vm, 1)                            # pinned on allocation
    return fresh


def _exec_runtime(cfg: PlaneConfig, s: st.PlaneState, obj_plan: torch.Tensor,
                  n_move: torch.Tensor, *, scalar: bool) -> st.PlaneState:
    """Move the deduped miss objects onto the ingress fill page(s): append
    slots by prefix arithmetic over the fill cursor, fresh log pages
    allocated before any row moves, then ONE ``gather_rows_into`` into the
    frame pool (batched) or one row at a time (scalar)."""
    P, V, F, O = cfg.page_objs, cfg.num_vpages, cfg.num_frames, cfg.num_objs
    R, D = obj_plan.shape[0], cfg.obj_dim

    cur0 = s.fill_vpage
    have = cur0 >= 0
    a0 = torch.where(have, take(s.alloc_count, cur0.clamp_min(0)), P)
    free0 = P - a0
    use0 = torch.minimum(n_move, free0)
    overflow = n_move - use0
    n_fresh = (overflow + P - 1) // P
    MAXF = (R + P - 1) // P + 1          # static bound

    if scalar:
        fresh = torch.full((MAXF,), -1, dtype=I32, device=s.device)
        for j in range(MAXF):
            do = n_fresh > j
            s, v = paths._fresh_vpage(cfg, s, do=do)
            fresh[j] = torch.where(do, v, -1)
    else:
        fresh = _fresh_vpages(cfg, s, n_fresh, MAXF)

    # ---- destination of move t: cursor first, then fresh pages in order
    t = _arange(R, obj_plan)
    valid = t < n_move
    tt = t - use0
    in_cur = t < use0
    v_new = torch.where(in_cur, cur0.clamp_min(0),
                        fresh[(tt // P).clamp(0, MAXF - 1)])
    v_new = torch.where(valid, v_new, 0)
    slot_new = torch.where(valid, torch.where(in_cur, a0 + t, tt % P), 0)

    o = obj_plan.clamp_min(0)
    old = s.obj_loc[o]
    v_old, slot_old = old // P, old % P

    if scalar:
        slab_rows = s.slab.view(-1, D)
        frame_rows = s.frames.view(-1, D)
        for k in range(R):
            do = valid[k]
            dst = v_new[k] * P + slot_new[k]
            f_new = take(s.frame_of, v_new[k])
            row = take(slab_rows, v_old[k] * P + slot_old[k])
            put(frame_rows, f_new * P + slot_new[k], row, do)
            put(s.obj_loc, o[k], dst, do)
            put(s.obj_of.view(-1), dst, o[k], do)
            add(s.alloc_count, v_new[k], 1, do)
            add(s.live_count, v_new[k], 1, do)
            put(s.cat.view(-1), dst, True, do)
            paths._kill_old_copy(cfg, s, v_old[k], slot_old[k], do)
    else:
        # one batched gather straight into the frame pool (the CUDA
        # object-ingress kernel on the card); masked moves write zeros into
        # the trash frame's first row
        src_flat = torch.where(valid, v_old * P + slot_old, -1)
        f_dst = torch.where(valid, s.frame_of[v_new] * P + slot_new, F * P)
        kops.gather_rows_into(s.frames.view(-1, D), f_dst, s.slab.view(-1, D),
                              src_flat, impl=cfg.kernel_impl)
        dst_flat = torch.where(valid, v_new * P + slot_new, V * P)
        old_flat = torch.where(valid, v_old * P + slot_old, V * P)
        v_new_m = torch.where(valid, v_new, V)
        v_old_m = torch.where(valid, v_old, V)
        obj_of = s.obj_of.view(-1)
        obj_of[dst_flat] = o
        put(obj_of, old_flat, -1)
        add(s.live_count, v_new_m, 1)
        add(s.live_count, v_old_m, -1)
        s.obj_loc[torch.where(valid, o, O)] = v_new * P + slot_new
        add(s.alloc_count, v_new_m, 1)
        put(s.cat.view(-1), dst_flat, True)
        # GC source pages this batch fully drained (deferred equivalent of
        # the scalar path's per-move _kill_old_copy)
        touched = torch.zeros((V + 1,), dtype=torch.bool, device=s.device)
        put(touched, v_old_m, True)
        drained = touched & (s.live_count == 0) & (s.pin == 0)
        s.backing.copy_(torch.where(drained, FREE, s.backing))
        s.dirty &= ~drained

    # ---- cursor bookkeeping: the last fresh page becomes the fill cursor;
    # the retired cursor and intermediate (already-full) fresh pages unpin
    retired = (n_fresh > 0) & have
    add(s.pin, cur0.clamp_min(0), -1, retired)
    j = _arange(MAXF, fresh)
    add(s.pin, torch.where(j < n_fresh - 1, fresh.clamp_min(0), V), -1)
    s.fill_vpage = torch.where(
        n_fresh > 0, take(fresh, (n_fresh - 1).clamp(0, MAXF - 1)), cur0)
    st.bump(s.stats, obj_ins=n_move)
    return s


# --------------------------------------------------------------------------
# finish: profiling pass + batched result gather
# --------------------------------------------------------------------------

def _profile(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor, *,
             with_cat: bool, with_obj_last: bool, scalar: bool
             ) -> st.PlaneState:
    """Record every access at its *final* location in one vectorized pass.
    Padded (negative-id) requests profile nothing (trash rows)."""
    valid = obj_ids >= 0
    va = s.obj_loc[obj_ids.clamp_min(0)]
    v, slot = va // cfg.page_objs, va % cfg.page_objs
    v = torch.where(valid, v, cfg.num_vpages)
    oid = torch.where(valid, obj_ids, cfg.num_objs)
    if scalar:
        for i in range(obj_ids.shape[0]):
            if with_cat:
                paths.touch(cfg, s, v[i], slot[i],
                            obj_id=oid[i] if with_obj_last else None)
            else:
                put(s.clock, v[i], s.step)
                if with_obj_last:
                    put(s.obj_last, oid[i], s.step)
        return s
    if with_cat:
        put(s.cat.view(-1), v * cfg.page_objs + slot, True)
        put(s.access.view(-1), v * cfg.page_objs + slot, True)
    s.clock[v] = s.step
    if with_obj_last:
        s.obj_last[oid] = s.step
    return s


def _gather_final(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                  *, scalar: bool) -> torch.Tensor:
    """Read every requested row at its final location with one batched
    gather per tier (a target paged out again mid-batch is served from its
    written-back slab copy).  Padded requests read as zero rows."""
    P, D = cfg.page_objs, cfg.obj_dim
    valid = obj_ids >= 0
    va = s.obj_loc[obj_ids.clamp_min(0)]
    v, slot = va // P, va % P
    local = s.backing[v] == LOCAL
    frame_rows, slab_rows = s.frames.view(-1, D), s.slab.view(-1, D)
    if scalar:
        out = torch.zeros((obj_ids.shape[0], D), dtype=cfg.dtype,
                          device=s.device)
        for i in range(obj_ids.shape[0]):
            f = take(s.frame_of, v[i]).clamp_min(0)
            out[i] = torch.where(local[i], take(frame_rows, f * P + slot[i]),
                                 take(slab_rows, v[i] * P + slot[i]))
        return torch.where(valid[:, None], out, torch.zeros_like(out))
    fidx = torch.where(local, s.frame_of[v].clamp_min(0) * P + slot, -1)
    sidx = torch.where(local, -1, v * P + slot)
    rows_l = kops.gather_rows(frame_rows, fidx, impl=cfg.kernel_impl)
    rows_r = kops.gather_rows(slab_rows, sidx, impl=cfg.kernel_impl)
    rows = torch.where(local[:, None], rows_l, rows_r)
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


# --------------------------------------------------------------------------
# the engine entry points
# --------------------------------------------------------------------------

def _resolve(cfg: PlaneConfig, mode) -> bool:
    mode = mode or cfg.access_mode
    if mode not in ("batch", "reference"):
        raise ValueError(f"unknown access mode: {mode!r}")
    return mode == "reference"


def _begin(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
           plan: AccessPlan, prefetch_hits: bool = True) -> torch.Tensor:
    """The common head of every execute: step, hit/miss stats, target
    recency (soft pin) and, except on the object plane, prefetch coverage.
    Returns the profiled ids (unserved requests profile as padded)."""
    nv = _count(obj_ids >= 0)
    s.step = s.step + 1
    st.bump(s.stats, hits=nv - plan.n_miss, misses=plan.n_miss,
            fetch_failures=plan.n_failed, egress_failures=plan.n_egress)
    s.clock[torch.where(plan.served, plan.vpage, cfg.num_vpages)] = s.step
    if prefetch_hits:
        _account_prefetch_hits(cfg, s, plan)
    return torch.where(plan.served, obj_ids, -1)


def execute_access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                   plan: AccessPlan, *, mode: str | None = None):
    """Execute a precomputed ``AccessPlan``: both ingress paths, profiling,
    final gather.  Returns ``(state, rows[R, D])`` with zero rows for padded
    or unserved requests.  ``mode="batch"`` and ``mode="reference"`` replay
    the same plan and agree bit for bit."""
    scalar = _resolve(cfg, mode)
    with trace.span("engine.execute.begin"):
        pids = _begin(cfg, s, obj_ids, plan)
    with trace.span("engine.execute.paging"):
        _exec_paging(cfg, s, plan, scalar=scalar)
    with trace.span("engine.execute.runtime"):
        _exec_runtime(cfg, s, plan.obj_plan, plan.n_objs, scalar=scalar)
    with trace.span("engine.execute.profile"):
        _profile(cfg, s, pids, with_cat=True, with_obj_last=True,
                 scalar=scalar)
    with trace.span("engine.execute.gather"):
        return s, _gather_final(cfg, s, pids, scalar=scalar)


def access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor, *,
           mode: str | None = None, shard=None, degraded: bool = False):
    """Batched hybrid access: plan, execute both ingress paths, profile,
    gather.  Returns ``(state, rows[R, D])``."""
    return execute_access(
        cfg, s, obj_ids,
        plan_access(cfg, s, obj_ids, shard=shard, degraded=degraded),
        mode=mode)


def update(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
           rows: torch.Tensor, *, mode: str | None = None, shard=None,
           degraded=False) -> st.PlaneState:
    """Batched write-through-local: fault in, overwrite rows (last write
    wins for duplicate ids), mark dirty.  An unserved request writes
    nothing."""
    plan = plan_access(cfg, s, obj_ids, shard=shard, degraded=degraded,
                       for_update=True)
    return execute_update(cfg, s, obj_ids, rows, plan, mode=mode)


def execute_update(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                   rows: torch.Tensor, plan: AccessPlan, *,
                   mode: str | None = None) -> st.PlaneState:
    """Execute a precomputed write-through plan (the second half of
    ``update``)."""
    scalar = _resolve(cfg, mode)
    P, V, F, D = cfg.page_objs, cfg.num_vpages, cfg.num_frames, cfg.obj_dim
    R = obj_ids.shape[0]
    rows = rows.to(cfg.dtype)
    pids = _begin(cfg, s, obj_ids, plan)
    _exec_paging(cfg, s, plan, scalar=scalar)
    _exec_runtime(cfg, s, plan.obj_plan, plan.n_objs, scalar=scalar)
    _profile(cfg, s, pids, with_cat=True, with_obj_last=True, scalar=scalar)

    served = plan.served
    va = s.obj_loc[obj_ids.clamp_min(0)]
    v, slot = va // P, va % P
    local = s.backing[v] == LOCAL
    vw = torch.where(served, v, V)
    frame_rows, slab_rows = s.frames.view(-1, D), s.slab.view(-1, D)
    if scalar:
        for i in range(R):
            to_frames = served[i] & local[i]
            f = take(s.frame_of, v[i]).clamp_min(0)
            put(frame_rows, f * P + slot[i], rows[i], to_frames)
            put(s.dirty, v[i], True, to_frames)
            put(slab_rows, vw[i] * P + slot[i], rows[i], ~to_frames)
        return s

    # last-wins dedup for duplicate ids, then one scatter per tier
    i = _arange(R, obj_ids)
    same = obj_ids[None, :] == obj_ids[:, None]
    last = (torch.where(same, i[None, :], -1).amax(dim=1) == i) & served
    fidx = torch.where(last & local, s.frame_of[v].clamp_min(0) * P + slot,
                       F * P)
    sidx = torch.where(last & ~local, v * P + slot, V * P)
    frame_rows[fidx] = rows
    slab_rows[sidx] = rows
    put(s.dirty, torch.where(served & local, v, V), True)
    return s


# --------------------------------------------------------------------------
# evacuation append-stream planning (used by plane.execute_evacuate)
# --------------------------------------------------------------------------

def plan_append_stream(cfg: PlaneConfig, s: st.PlaneState, which: str,
                       mask: torch.Tensor, do=None):
    """Plan appending the masked slots (``[P]`` bool) of one page to the
    named fill stream, where ``do`` holds.  Allocates the (at most one)
    fresh page up front (pinned), moves the stream cursor and bumps the
    destination alloc/live counts.  Returns ``(state, v_new[P],
    slot_new[P], in_cur[P], cursor_page, fresh_page, retired_page)``.  A
    retired cursor stays pinned until the caller's writes land; the caller
    unpins it."""
    P, V = cfg.page_objs, cfg.num_vpages
    n = _count(mask)
    cur0 = getattr(s, which)
    have = cur0 >= 0
    a0 = torch.where(have, take(s.alloc_count, cur0.clamp_min(0)), P)
    free0 = P - a0
    use0 = torch.minimum(n, free0)
    need_fresh = n > free0
    s, vfresh = paths._fresh_vpage(cfg, s, do=paths._and(do, need_fresh))
    vfresh = torch.where(need_fresh, vfresh, -1)
    rank = _cumsum(mask) - 1
    in_cur = rank < use0
    v_new = torch.where(in_cur, cur0.clamp_min(0), vfresh.clamp_min(0))
    slot_new = torch.where(in_cur, a0 + rank, rank - use0)
    vm = torch.where(paths._and(do, mask), v_new, V)
    add(s.alloc_count, vm, 1)
    add(s.live_count, vm, 1)
    retired_page = torch.where(need_fresh & have, cur0, -1)
    setattr(s, which, paths.sel(do, torch.where(need_fresh, vfresh, cur0),
                                cur0))
    used_cur = torch.where(use0 > 0, cur0, -1)
    return s, v_new, slot_new, in_cur, used_cur, vfresh, retired_page


# --------------------------------------------------------------------------
# baseline planes on the same engine
# --------------------------------------------------------------------------

def execute_paging_access(cfg: PlaneConfig, s: st.PlaneState,
                          obj_ids: torch.Tensor, plan: AccessPlan, *,
                          mode: str | None = None):
    """Execute a Fastswap-analogue plan (built with ``split_by_psf=False``:
    every miss takes the paging path; no CAT, no object moves).  Returns
    ``(state, rows[R, D])``."""
    scalar = _resolve(cfg, mode)
    pids = _begin(cfg, s, obj_ids, plan)     # page-level recency only
    _exec_paging(cfg, s, plan, scalar=scalar)
    return s, _gather_final(cfg, s, pids, scalar=scalar)


def paging_access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                  *, mode: str | None = None, shard=None,
                  degraded: bool = False):
    """Fastswap-analogue plane on the batch engine."""
    plan = plan_access(cfg, s, obj_ids, split_by_psf=False, shard=shard,
                       degraded=degraded)
    return execute_paging_access(cfg, s, obj_ids, plan, mode=mode)


def execute_object_access(cfg: PlaneConfig, s: st.PlaneState,
                          obj_ids: torch.Tensor, plan: AccessPlan,
                          reclaim_free_target: int = 2, *,
                          mode: str | None = None, reclaim=None):
    """Execute an AIFM-analogue plan (built with ``all_runtime=True``:
    every miss object-fetches through the runtime plan); afterwards
    ``reclaim`` (the object-level LRU egress loop,
    ``baselines.object_reclaim`` or a ``baselines.ObjectReclaim``) runs if
    frames are tight.  It is told the most frames this call's fresh log
    pages can have taken (``max_alloc``)."""
    scalar = _resolve(cfg, mode)
    pids = _begin(cfg, s, obj_ids, plan, prefetch_hits=False)
    _exec_runtime(cfg, s, plan.obj_plan, plan.n_objs, scalar=scalar)
    # object-level hotness tracking (the expensive always-on metadata)
    _profile(cfg, s, pids, with_cat=False, with_obj_last=True, scalar=scalar)
    rows = _gather_final(cfg, s, pids, scalar=scalar)
    if reclaim is not None:
        R, P = obj_ids.shape[0], cfg.page_objs
        reclaim(cfg, s, reclaim_free_target, max_alloc=(R + P - 1) // P + 1)
    return s, rows


def object_access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                  reclaim_free_target: int = 2, *, mode: str | None = None,
                  reclaim=None, shard=None, degraded: bool = False):
    """AIFM-analogue plane on the batch engine."""
    plan = plan_access(cfg, s, obj_ids, all_runtime=True, shard=shard,
                       degraded=degraded)
    return execute_object_access(cfg, s, obj_ids, plan, reclaim_free_target,
                                 mode=mode, reclaim=reclaim)
