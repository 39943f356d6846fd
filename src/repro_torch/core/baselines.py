"""Baseline data planes, per the paper's evaluation (§5.1 "Baselines")
(PyTorch port of ``repro.core.baselines``).

* ``paging_access`` — Fastswap analogue: page-granular ingress and egress,
  sequential readahead, no object machinery at all.
* ``object_access`` — AIFM analogue: object-granular ingress and egress.
  A true object-level LRU (per-object ``obj_last`` stamps) is scanned on
  memory pressure to evict the coldest objects one by one into a remote
  log.  ``lru_scan_budget > 0`` scans a rotating window of that many
  objects from ``lru_hand`` instead (the CPU-starved regime: near-arbitrary
  victims).

Both ingress paths run on the plan-then-execute engine of
:mod:`repro_torch.core.batch`, as in JAX.  The functions update the state
in place.

**The reclaim loop.**  JAX's ``object_reclaim`` is a ``lax.while_loop``
whose condition (free frames < ``target_free``) is a device value, around
a ``fori_loop`` of ``object_evict_batch`` evictions, bounded by
``num_objs // object_evict_batch + 2`` rounds.  XLA's while loop on a GPU
reads its predicate back to the host once per iteration as well.  No
static bound covers one tick's rounds (freeing a frame can take evicting
up to every live object of the pool), and a masked loop of a million
rounds is not an option, so this port reads the condition on the host,
once per round: one device-to-host read of ``[free frames, any evictable
object]`` before each round and one after the last.  Within a round the
``object_evict_batch`` evictions are masked device updates with no sync,
and which objects are evicted, in which order, is JAX's.

Two host-side facts cut the reads, without changing the result:

* :class:`ObjectReclaim` keeps a lower bound on the free frames between
  calls: the last value it read, less the most frames each access since
  has taken (``max_alloc``, one per fresh log page; nothing else on the
  object plane's path takes a frame).  While that bound is at least
  ``target_free`` the condition is false and nothing is read.
* When no local unpinned object exists, every remaining round evicts
  nothing (a window scan of ``lru_scan_budget`` reaches every object
  within ``ceil(num_objs / budget)`` attempts, so it would find one if one
  existed): those rounds only add to ``lru_scans`` and move ``lru_hand``,
  which the port does in one step instead of up to a million reads.

``reads`` and ``rounds`` count what each instance did.
"""
from __future__ import annotations

import time

import torch

from . import batch as batch_lib
from . import paths
from . import state as st
from .layout import FREE, LOCAL, REMOTE, PlaneConfig
from .paths import INF32, add, put, take

I32 = torch.int32


# --------------------------------------------------------------------------
# Fastswap analogue
# --------------------------------------------------------------------------

def paging_access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                  *, mode: str | None = None, shard=None,
                  degraded: bool = False):
    """Page-granular plane: every miss pages in (with readahead); no CAT,
    no PSF consultation, no object moves.  Returns ``(state, rows)``."""
    return batch_lib.paging_access(cfg, s, obj_ids, mode=mode, shard=shard,
                                   degraded=degraded)


# --------------------------------------------------------------------------
# AIFM analogue
# --------------------------------------------------------------------------

def _evictable(cfg: PlaneConfig, s: st.PlaneState, o: torch.Tensor):
    """bool mask over object ids ``o``: placed on a LOCAL, unpinned page."""
    V = cfg.num_vpages
    loc = s.obj_loc[o]
    vp = (loc // cfg.page_objs).clamp(0, V - 1)
    return (loc >= 0) & (s.backing[vp] == LOCAL) & (s.pin[vp] == 0)


def _object_out_coldest(cfg: PlaneConfig, s: st.PlaneState) -> st.PlaneState:
    """Evict the one object the object-level LRU picks (first minimum of
    ``obj_last`` among evictable objects, as ``jnp.argmin``); with
    ``lru_scan_budget`` only a rotating window from ``lru_hand``."""
    O, P, D = cfg.num_objs, cfg.page_objs, cfg.obj_dim
    B = cfg.lru_scan_budget
    if B and B < O:
        idx = (s.lru_hand + torch.arange(B, dtype=I32, device=s.device)) % O
        cand = _evictable(cfg, s, idx)
        score = torch.where(cand, s.obj_last[idx], INF32)
        o = take(idx, torch.argmin(score))
        scanned = B
        s.lru_hand = (s.lru_hand + B) % O
    else:
        cand = _evictable(cfg, s, slice(0, O))
        score = torch.where(cand, s.obj_last[:O], INF32)
        o = torch.argmin(score).to(I32)
        scanned = O
    valid = cand.any()
    va = take(s.obj_loc, o)
    v, slot = va // P, va % P
    f = take(s.frame_of, v.clamp_min(0)).clamp_min(0)
    row = take(s.frames.view(-1, D), f * P + slot)
    _append_obj_remote(cfg, s, o, row, do=valid)
    st.bump(s.stats, lru_scans=scanned, obj_outs=valid.to(I32))
    return s


def _append_obj_remote(cfg: PlaneConfig, s: st.PlaneState, o, row,
                       do=None) -> st.PlaneState:
    """Move object ``o`` (data ``row``) to the remote log, where ``do``
    holds (object-granular egress).  Objects evicted at different times
    land on unrelated remote pages: the locality disruption the paper
    attributes to object egress."""
    P, V, D = cfg.page_objs, cfg.num_vpages, cfg.obj_dim
    cur = s.remote_fill_vpage
    full = take(s.alloc_count, cur.clamp_min(0)) >= P
    need = paths._and(do, (cur < 0) | full)
    # a fresh remote log page: the first FREE vpage (argmax, first index)
    paths.unpin_page(s, cur, do=need & (cur >= 0))
    v = torch.argmax((s.backing[:V] == FREE).to(torch.int8)).to(I32)
    put(s.backing, v, REMOTE, need)
    put(s.alloc_count, v, 0, need)
    put(s.live_count, v, 0, need)
    put(s.obj_of, v, -1, need)
    put(s.car_ema, v, 0.0, need)              # fresh page identity
    s.remote_fill_vpage = torch.where(need, v, cur)
    paths.pin_page(s, v, need)
    v_new = s.remote_fill_vpage.clamp_min(0)
    slot_new = take(s.alloc_count, v_new)
    old = take(s.obj_loc, o)
    v_old, slot_old = old // P, old % P
    dst = v_new * P + slot_new
    put(s.slab.view(-1, D), dst, row, do)
    put(s.obj_loc, o, dst, do)
    put(s.obj_of.view(-1), dst, o, do)
    add(s.alloc_count, v_new, 1, do)
    add(s.live_count, v_new, 1, do)
    return paths._kill_old_copy(cfg, s, v_old, slot_old, do)


class ObjectReclaim:
    """The object plane's egress loop with what the host knows between
    calls (see the module docstring): evict the coldest objects,
    ``object_evict_batch`` a round, until ``target_free`` frames are free.

    One instance serves one plane state, and only object-plane accesses
    may change that state between its calls (each tells it ``max_alloc``);
    anything else must use a new instance.  ``reads`` counts device-to-host
    reads, ``rounds`` eviction rounds, ``seconds`` host time inside rounds
    (with the reads, which wait for the device)."""

    def __init__(self):
        self.free_lb = None     # lower bound on free frames; None = unknown
        self.reads = 0
        self.rounds = 0
        self.seconds = 0.0

    def _read(self, cfg: PlaneConfig, s: st.PlaneState):
        free = (s.vpage_of[:cfg.num_frames] < 0).sum(dtype=I32)
        any_cand = _evictable(cfg, s, slice(0, cfg.num_objs)).any().to(I32)
        self.reads += 1
        return torch.stack([free, any_cand]).tolist()

    def __call__(self, cfg: PlaneConfig, s: st.PlaneState, target_free: int,
                 max_alloc=None) -> st.PlaneState:
        if self.free_lb is not None and max_alloc is not None:
            self.free_lb -= max_alloc
            if self.free_lb >= target_free:
                return s                     # the loop condition is false
        E = cfg.object_evict_batch
        max_iter = cfg.num_objs // max(E, 1) + 2
        it = 0
        t0 = time.perf_counter()
        free, any_cand = self._read(cfg, s)
        while free < target_free and it < max_iter:
            if not any_cand:
                self._idle_rounds(cfg, s, (max_iter - it) * E)
                break
            for _ in range(E):
                _object_out_coldest(cfg, s)
            it += 1
            free, any_cand = self._read(cfg, s)
        self.rounds += it
        self.seconds += time.perf_counter() - t0
        self.free_lb = free
        return s

    @staticmethod
    def _idle_rounds(cfg: PlaneConfig, s: st.PlaneState, n: int) -> None:
        """``n`` eviction attempts that find nothing evictable: each adds
        its scan to ``lru_scans`` (int32, wrapping as JAX's does) and, in
        a window scan, moves ``lru_hand`` by the window."""
        O, B = cfg.num_objs, cfg.lru_scan_budget
        scanned = B if B and B < O else O
        bump = (n * scanned) & 0xFFFFFFFF
        s.stats.lru_scans = (s.stats.lru_scans.to(torch.int64) + bump).to(
            I32)
        if B and B < O:
            s.lru_hand = ((s.lru_hand.to(torch.int64) + n * B) % O).to(I32)


def object_reclaim(cfg: PlaneConfig, s: st.PlaneState, target_free: int,
                   max_alloc=None) -> st.PlaneState:
    """Evict coldest objects until ``target_free`` frames are free (one
    call with nothing known beforehand: at least one host read)."""
    return ObjectReclaim()(cfg, s, target_free, max_alloc)


def object_access(cfg: PlaneConfig, s: st.PlaneState, obj_ids: torch.Tensor,
                  reclaim_free_target: int = 2, *, mode: str | None = None,
                  shard=None, degraded: bool = False, reclaim=None):
    """Object-granular plane (AIFM analogue): every miss object-fetches;
    after the batch, reclaim via the object-level LRU if frames are tight.
    ``reclaim`` defaults to a fresh :func:`object_reclaim`; a caller that
    serves many batches passes one :class:`ObjectReclaim`."""
    return batch_lib.object_access(cfg, s, obj_ids, reclaim_free_target,
                                   mode=mode, shard=shard, degraded=degraded,
                                   reclaim=reclaim or object_reclaim)
