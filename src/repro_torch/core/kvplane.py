"""Tiered KV cache on the hybrid plane (port of ``repro.core.kvplane``).

Two modes, the two ends of the paper's spectrum:

* **dense paging mode** (decode_32k): the whole cache is local, in a
  paged frame pool indirected by a page table.  Dense decode touches every
  row, so every card bit sets, CAR is 1 and every page stays on the paging
  path; the always-on profiling still runs.
* **sparse hybrid mode** (long_500k): frames hold a hot subset of pages,
  the rest stay in the far tier (the slab).  Each step scores the page
  summaries (kmax/kmin) against q without fetching (``kernels.topk_pages``),
  plans ONE fetch for the whole ``[B, K]`` selection (``plan_fetch``) and
  runs it as one batched ``gather_pages`` (whole pages for PSF=paging,
  the CAT-marked hot rows packed to the front for PSF=runtime), attends
  over the local pool (``kernels.paged_attention``), marks the attended
  rows in the CAT, and recomputes an evicted page's PSF from its CAR.
  ``fetch_mode="reference"`` replays the same plan one fetch at a time
  (the oracle, bit for bit).

Where the port departs from the JAX form, and why:

* **State in place.**  Every function updates its ``KVPlaneState`` in
  place and returns it, keeping JAX's ``(out, state)`` returns.  The JAX
  serve loop gets the same effect from its memoized jit entries that
  donate the state (``jitted_attend_sparse``), which need no counterpart
  here.  ``KVPlaneState.clone`` copies a state for an oracle.
* **Trash rows.**  JAX drops a scatter at an out-of-bounds index; here
  each scatter target carries one extra trailing row (the frame pool a
  trash frame ``F``, the ``[B, NP]`` tables a trash slot ``B*NP`` of their
  flat form) that takes such writes.  ``KVPlaneState.view`` gives the
  logical tensors.
* **Duplicate scatter targets: the last write wins.**  In
  ``attend_sparse`` an invalid selection is sent to page 0 and frame 0,
  where it writes the old value back; JAX on the CPU applies duplicate
  writes in order, so a valid entry on page 0 or frame 0 loses its CAT or
  clock update to a later invalid one.  The port resolves duplicates
  explicitly (``_last_wins``), never through ``index_put_`` with repeated
  indices, which is undefined on CUDA.
* **``page_table[b, tops]`` with ``tops == -1``** reads page NP-1 in JAX
  (a negative index wraps); ``attend_sparse`` does the same on purpose,
  while ``attend_sparse_partial`` guards the index as JAX does there.
* **Ties.**  ``lax.top_k`` takes the lowest index among equals, so the
  port sorts stably (``batch.stable_order``); ``jnp.argsort`` on bools is
  stable, so is ``torch.argsort(stable=True)`` on their int cast.
* **No ``lax.cond``/``fori_loop``.**  The reference executor runs a
  static trip count of masked updates; nothing on the batched path syncs
  with the host.
* **Sharded decode** takes a list of per-shard states (JAX's leading
  shard axis) and runs the shards as a Python loop on one device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import ops as kops
from . import state as st
from .batch import majority_stride, stable_order
from .paths import INF32, put, take

NEG_INF = -1e30
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class KVPlaneConfig:
    kv_heads: int
    head_dim: int
    page_tokens: int          # P: tokens per page
    num_pages: int            # NP: logical pages (covers max seq len)
    num_frames: int           # F: local frame pool (== B*NP in dense mode)
    batch: int                # sequences served per shard
    sparse_topk: int = 0      # 0 = dense paging mode; >0 = hybrid sparse
    fetch_budget: int = 8     # pages ensured local per step (sparse mode)
    car_threshold: float = 0.8
    dtype: torch.dtype = torch.bfloat16
    fetch_mode: str = "batch"   # "batch" (vectorized) | "reference" (scalar)
    kernel_impl: str = "auto"   # kernels.ops dispatch
    prefetch: str = "none"      # "none" | "sequential" | "majority"
    prefetch_budget: int = 0    # lookahead pages planned per sequence
    faults: object = None       # core.faults.Schedule (None = no faults)

    @property
    def dense(self) -> bool:
        return self.sparse_topk == 0

    @property
    def plan_entries(self) -> int:
        """Fetch-plan length: demand budget + lookahead, per sequence."""
        pf = self.prefetch_budget if self.prefetch != "none" else 0
        return self.batch * (self.fetch_budget + pf)


# fields with a trash row, by the extent of their first padded axis
_FRAME_AXIS1 = ("k_frames", "v_frames")       # [KVH, F+1, P, Dh]
_FRAME_AXIS0 = ("frame_page", "clock")        # [F+1]
_PAGE_AXIS0 = ("page_table", "cat", "psf", "hot_hint", "page_rows")  # [B*NP+1, ...]


@dataclasses.dataclass(eq=False)
class KVPlaneState:
    """Per-layer KV plane state; fields, order and dtypes as the JAX
    ``KVPlaneState``.  Stored with trash rows: the frame pool has F+1
    frames, and the ``[B, NP]`` tables are stored flat as ``[B*NP+1]``."""

    k_frames: torch.Tensor    # [KVH, F+1, P, Dh]
    v_frames: torch.Tensor    # [KVH, F+1, P, Dh]
    page_table: torch.Tensor  # [B*NP+1] int32: logical page -> frame (-1 far)
    k_slab: torch.Tensor      # [KVH, B*NP, P, Dh] (size 1 in dense mode)
    v_slab: torch.Tensor      # [KVH, B*NP, P, Dh]
    kmax: torch.Tensor        # [KVH, B*NP, Dh] f32 page summaries
    kmin: torch.Tensor        # [KVH, B*NP, Dh] f32
    cat: torch.Tensor         # [B*NP+1, P] bool
    psf: torch.Tensor         # [B*NP+1] bool
    hot_hint: torch.Tensor    # [B*NP+1, P] bool: CAT snapshot at page-out
    page_rows: torch.Tensor   # [B*NP+1] int32: valid rows in the frame copy
    frame_page: torch.Tensor  # [F+1] int32: frame -> b*NP+page (-1 free)
    clock: torch.Tensor       # [F+1] int32
    step: torch.Tensor        # [] int32

    _fields = ()  # filled below

    def view(self, cfg: KVPlaneConfig, name: str) -> torch.Tensor:
        """The logical (trash-free) tensor of field ``name``, in the JAX
        shape."""
        x = getattr(self, name)
        if name in _FRAME_AXIS1:
            return x[:, :-1]
        if name in _FRAME_AXIS0:
            return x[:-1]
        if name in _PAGE_AXIS0:
            return _bn(cfg, x)
        return x

    def clone(self) -> "KVPlaneState":
        return KVPlaneState(**{k: getattr(self, k).clone()
                               for k in self._fields})


KVPlaneState._fields = tuple(f.name for f in
                             dataclasses.fields(KVPlaneState))


def _bn(cfg: KVPlaneConfig, x: torch.Tensor) -> torch.Tensor:
    """``[B*NP+1, ...]`` -> the ``[B, NP, ...]`` view of its logical part."""
    return x[:-1].view(cfg.batch, cfg.num_pages, *x.shape[1:])


def init(cfg: KVPlaneConfig, device="cuda") -> KVPlaneState:
    dev = st.resolve_device(device)
    KVH, F, P, Dh, B, NP = (cfg.kv_heads, cfg.num_frames, cfg.page_tokens,
                            cfg.head_dim, cfg.batch, cfg.num_pages)
    i32 = dict(dtype=I32, device=dev)
    slab_pages = 1 if cfg.dense else B * NP
    if cfg.dense:
        # fully resident: page (b, j) -> frame b*NP + j
        if F != B * NP:
            raise ValueError(f"dense mode: {F} frames do not cover the "
                             f"cache of {B} x {NP} pages")
        pt = torch.arange(B * NP + 1, **i32)
        frame_page = torch.arange(F + 1, **i32)
    else:
        pt = torch.full((B * NP + 1,), -1, **i32)
        frame_page = torch.full((F + 1,), -1, **i32)
    pt[-1] = -1
    frame_page[-1] = -1
    return KVPlaneState(
        k_frames=torch.zeros((KVH, F + 1, P, Dh), dtype=cfg.dtype, device=dev),
        v_frames=torch.zeros((KVH, F + 1, P, Dh), dtype=cfg.dtype, device=dev),
        page_table=pt,
        k_slab=torch.zeros((KVH, slab_pages, P, Dh), dtype=cfg.dtype,
                           device=dev),
        v_slab=torch.zeros((KVH, slab_pages, P, Dh), dtype=cfg.dtype,
                           device=dev),
        kmax=torch.full((KVH, slab_pages, Dh), -torch.inf,
                        dtype=torch.float32, device=dev),
        kmin=torch.full((KVH, slab_pages, Dh), torch.inf,
                        dtype=torch.float32, device=dev),
        cat=torch.zeros((B * NP + 1, P), dtype=torch.bool, device=dev),
        psf=torch.ones((B * NP + 1,), dtype=torch.bool, device=dev),
        hot_hint=torch.zeros((B * NP + 1, P), dtype=torch.bool, device=dev),
        page_rows=torch.zeros((B * NP + 1,), **i32),
        frame_page=frame_page,
        clock=torch.zeros((F + 1,), **i32),
        step=torch.zeros((), **i32),
    )


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _last_wins(idx: torch.Tensor, trash: int) -> torch.Tensor:
    """``idx`` [N] with every write but the last to each target sent to
    ``trash``: JAX on the CPU applies duplicate scatter writes in order."""
    i = _arange(idx.shape[0], idx)
    same = idx[None, :] == idx[:, None]
    last = torch.where(same, i[None, :], -1).amax(dim=1) == i
    return torch.where(last, idx, trash)


# --------------------------------------------------------------------------
# dense paging mode
# --------------------------------------------------------------------------

def append_dense(cfg: KVPlaneConfig, s: KVPlaneState, k_new, v_new, lengths):
    """Write one new token per sequence.  k/v_new: [B, KVH, Dh]; lengths
    [B]: the token goes at index lengths[b]."""
    B, P = cfg.batch, cfg.page_tokens
    page = (lengths // P).long()
    slot = (lengths % P).long()
    frame = _bn(cfg, s.page_table)[torch.arange(B, device=page.device),
                                   page].long()
    s.k_frames[:, frame, slot] = k_new.transpose(0, 1).to(cfg.dtype)
    s.v_frames[:, frame, slot] = v_new.transpose(0, 1).to(cfg.dtype)
    s.step = s.step + 1
    return s


def attend_dense(cfg: KVPlaneConfig, s: KVPlaneState, q, lengths):
    """q: [B, H, Dh] -> [B, H, Dh] by paged attention over the frame pool,
    plus the always-on CAT profiling (dense touch: CAR -> 1)."""
    P, NP = cfg.page_tokens, cfg.num_pages
    page_lens = kops.lengths_to_page_lens(lengths, NP, P)
    out, _used = kops.paged_attention(q, s.k_frames, s.v_frames,
                                      _bn(cfg, s.page_table), page_lens,
                                      impl=cfg.kernel_impl)
    pos = torch.arange(NP * P, device=q.device).view(NP, P)
    touched = pos[None] < lengths[:, None, None]            # [B, NP, P]
    _bn(cfg, s.cat).logical_or_(touched)
    _bn(cfg, s.page_rows).copy_(page_lens)
    s.clock.copy_(s.step.expand(s.clock.shape))
    return out, s


# --------------------------------------------------------------------------
# sparse hybrid mode
# --------------------------------------------------------------------------

def write_page_to_slab(cfg: KVPlaneConfig, s: KVPlaneState, b: int,
                       page_idx, k_page, v_page):
    """Prefill helper: place a full page [KVH, P, Dh] in the far tier and
    update its summaries."""
    gp = torch.as_tensor(b * cfg.num_pages + page_idx,
                         device=s.k_slab.device).reshape(1).long()
    s.k_slab[:, gp] = k_page[:, None].to(cfg.dtype)
    s.v_slab[:, gp] = v_page[:, None].to(cfg.dtype)
    s.kmax[:, gp] = k_page.amax(dim=1).to(torch.float32)[:, None]
    s.kmin[:, gp] = k_page.amin(dim=1).to(torch.float32)[:, None]
    return s


class KVFetchPlan(NamedTuple):
    """Fixed-shape ingress plan of one sparse decode step: one entry per
    (sequence, budget slot) plus the lookahead section."""
    seq: torch.Tensor     # [N] int32 owning sequence
    page: torch.Tensor    # [N] int32 logical page to fetch (-1 = no-op)
    victim: torch.Tensor  # [N] int32 destination frame (distinct entries)


def _lookahead_candidates(cfg: KVPlaneConfig, s: KVPlaneState,
                          tops: torch.Tensor) -> torch.Tensor:
    """Decode-lookahead section of the fetch plan: ``[B, Qp]`` pages the
    top-page trajectory is trending toward (-1 pad), masked to valid,
    currently missing, PSF=paging pages not already selected.
    ``"sequential"`` extrapolates past the newest selected page by 1;
    ``"majority"`` along the Leap majority stride of the sorted
    selection's deltas (``batch.majority_stride``)."""
    B, K = tops.shape
    NP, Qp = cfg.num_pages, cfg.prefetch_budget
    valid = tops >= 0
    nv = valid.sum(dim=1, dtype=I32)                          # [B]
    srt = torch.sort(torch.where(valid, tops, INF32), dim=1).values
    if cfg.prefetch == "sequential":
        stride = torch.ones_like(nv)
        have = nv >= 1
    else:  # "majority"
        d = srt[:, 1:] - srt[:, :-1]
        nd = (nv - 1).clamp_min(0)
        pairs = [majority_stride(d[b], nd[b]) for b in range(B)]
        stride = torch.stack([p[0] for p in pairs])
        have = torch.stack([p[1] for p in pairs])
    base = srt.gather(1, (nv - 1).clamp(0, K - 1).long()[:, None])[:, 0]
    k = torch.arange(1, Qp + 1, dtype=I32, device=tops.device)
    cand = torch.where(have[:, None], base[:, None] + k[None] * stride[:, None],
                       -1)
    ok = (cand >= 0) & (cand < NP)
    safe = cand.clamp(0, NP - 1).long()
    ok &= _bn(cfg, s.page_table).gather(1, safe) < 0      # currently missing
    ok &= _bn(cfg, s.psf).gather(1, safe)                 # paging pages only
    ok &= ~(cand[:, :, None] == tops[:, None, :]).any(dim=2)
    return torch.where(ok, cand, -1)


def plan_fetch(cfg: KVPlaneConfig, s: KVPlaneState, tops: torch.Tensor
               ) -> KVFetchPlan:
    """ONE vectorized fetch plan for the whole ``[B, K]`` selection:
    per-sequence hit/miss, the first ``fetch_budget`` misses in rank
    order, the optional lookahead section, cross-sequence dedup, faulted
    fetches dropped, and victims from one stable sort of the frame pool's
    clocks with wanted-resident frames pinned (a fetch with no unpinned
    victim left is dropped, lookahead entries first)."""
    F, NP = cfg.num_frames, cfg.num_pages
    B, K = tops.shape
    fb = cfg.fetch_budget
    Qp = cfg.prefetch_budget if cfg.prefetch != "none" else 0
    N = cfg.plan_entries
    if N > F:
        raise ValueError(
            f"batch*(fetch_budget+prefetch_budget)={N} fetches per step "
            f"need at least that many frames (have {F})")
    valid = tops >= 0
    safe = tops.clamp_min(0).long()
    frames_of = _bn(cfg, s.page_table).gather(1, safe)          # [B, K]
    resident = valid & (frames_of >= 0)
    missing = valid & (frames_of < 0)

    # first `fetch_budget` missing pages per sequence (stable rank order)
    order = torch.argsort((~missing).to(I32), dim=1, stable=True)
    sel = tops.gather(1, order)[:, :fb]
    selm = missing.gather(1, order)[:, :fb]
    page = torch.where(selm, sel, -1).reshape(-1)
    seq = torch.arange(B, dtype=I32, device=tops.device).repeat_interleave(fb)
    if Qp:
        # all demand entries precede all lookahead entries
        page = torch.cat([page,
                          _lookahead_candidates(cfg, s, tops).reshape(-1)])
        seq = torch.cat([seq, torch.arange(B, dtype=I32, device=tops.device
                                           ).repeat_interleave(Qp)])

    # cross-sequence dedup on the flattened global page ids
    gp = seq * NP + page
    i = _arange(N, tops)
    ok = page >= 0
    same = (gp[None, :] == gp[:, None]) & ok[None, :]
    first = torch.where(same, i[None, :], N).amin(dim=1) == i
    page = torch.where(ok & first, page, -1)

    # a faulted remote fetch drops out before victim assignment
    fc = cfg.faults
    if fc is not None and fc.active:
        okf = page >= 0
        fail = okf & fc.fetch_fail(s.step + 1, seq * NP + page.clamp_min(0))
        page = torch.where(fail, -1, page)

    # victims: coldest unpinned frames first (lax.top_k(-score) order),
    # compacted onto the valid fetch entries
    pinned = torch.zeros((F + 1,), dtype=torch.bool, device=tops.device)
    put(pinned, torch.where(resident, frames_of, F), True)
    score = torch.where(pinned[:F], INF32, s.clock[:F])
    vals, victims = stable_order(score)
    vals, victims = vals[:N], victims[:N]
    ok = page >= 0
    rank = torch.cumsum(ok.to(I32), 0, dtype=I32) - 1
    usable = ok & (vals[rank.clamp(0, N - 1)] < INF32)
    page = torch.where(usable, page, -1)
    victim = victims[torch.where(usable, rank, N - 1)]
    return KVFetchPlan(seq=seq, page=page, victim=victim)


def _evict_math(cfg: KVPlaneConfig, cat_now, old_hint, old_rows):
    """PSF and hot-hint at page-out (shared by both executors): PSF from
    the CAR over the full page; the hint maps packed card bits back
    through the previous hint (packed slot i == i-th set bit of it)."""
    P = cfg.page_tokens
    car = cat_now.sum(dim=-1, dtype=torch.float32) / P
    rank = torch.cumsum(old_hint.to(I32), -1, dtype=I32) - 1
    packed_back = old_hint & cat_now.gather(-1, rank.clamp(0, P - 1).long())
    was_full = old_rows >= P
    hint = torch.where(was_full[..., None], cat_now, packed_back)
    thr = torch.full((), cfg.car_threshold, dtype=torch.float32,
                     device=car.device)
    return car >= thr, hint


def _ingress_math(cfg: KVPlaneConfig, psf, hot, page_fill):
    """Fetch path (shared by both executors): paging for first-touch pages
    and PSF=paging pages, else a packing permutation that moves the
    CAT-marked hot rows to the front (stable)."""
    P = cfg.page_tokens
    n_hot = hot.sum(dim=-1, dtype=I32)
    take_paging = psf | (n_hot == 0)
    perm = torch.argsort((~hot).to(I32), dim=-1, stable=True).to(I32)
    ident = torch.arange(P, dtype=I32, device=perm.device).expand(perm.shape)
    perm = torch.where(take_paging[..., None], ident, perm)
    rows = torch.where(take_paging, page_fill, n_hot).to(I32)
    return perm, rows


def _exec_fetch_batch(cfg: KVPlaneConfig, s: KVPlaneState,
                      plan: KVFetchPlan, fills: torch.Tensor) -> KVPlaneState:
    """The whole plan with batched data movement: every page-out as masked
    scatters, every page-in in ONE ``gather_pages`` call per KV tensor.
    The plan's touched pages are disjoint (distinct victims, resident
    evictees, missing fetches), so every read can use the entry state."""
    NP, F, BN = cfg.num_pages, cfg.num_frames, cfg.batch * cfg.num_pages
    b, pg, f = plan.seq, plan.page, plan.victim
    ok = pg >= 0
    safe_pg = pg.clamp_min(0)

    # ---- reads against the entry state ------------------------------------
    old_gp = s.frame_page[f]
    evict = ok & (old_gp >= 0)
    old = old_gp.clamp_min(0)
    new_psf, hint = _evict_math(cfg, s.cat[old], s.hot_hint[old],
                                s.page_rows[old])
    gp_new = b * NP + safe_pg
    perm, rows_new = _ingress_math(cfg, s.psf[gp_new], s.hot_hint[gp_new],
                                   fills.reshape(-1)[gp_new])

    # ---- page-out (metadata only: KV pages are never dirty) ---------------
    eidx = torch.where(evict, old, BN)
    s.psf[eidx] = new_psf
    s.hot_hint[eidx] = hint
    put(s.cat, eidx, False)
    put(s.page_rows, eidx, 0)
    put(s.page_table, eidx, -1)

    # ---- page-in: one batched page gather per KV tensor -------------------
    kpages = kops.gather_pages(s.k_slab, gp_new, perm, impl=cfg.kernel_impl,
                               masked=False)
    vpages = kops.gather_pages(s.v_slab, gp_new, perm, impl=cfg.kernel_impl,
                               masked=False)
    fdst = torch.where(ok, f, F)
    s.k_frames[:, fdst] = kpages
    s.v_frames[:, fdst] = vpages
    iidx = torch.where(ok, gp_new, BN)
    s.page_table[iidx] = f
    s.page_rows[iidx] = rows_new
    put(s.cat, iidx, False)
    s.frame_page[fdst] = gp_new
    s.clock[fdst] = s.step
    return s


def _exec_fetch_reference(cfg: KVPlaneConfig, s: KVPlaneState,
                          plan: KVFetchPlan, fills: torch.Tensor
                          ) -> KVPlaneState:
    """Scalar oracle: the identical plan one fetch at a time, each a
    masked update (a masked-off write lands in a trash row)."""
    NP, F = cfg.num_pages, cfg.num_frames
    fills = fills.reshape(-1)
    for j in range(plan.page.shape[0]):
        b, pg, f = plan.seq[j], plan.page[j], plan.victim[j]
        do = pg >= 0
        old_gp = take(s.frame_page, f)
        ev = do & (old_gp >= 0)
        old = old_gp.clamp_min(0)
        new_psf, hint = _evict_math(cfg, take(s.cat, old)[None],
                                    take(s.hot_hint, old)[None],
                                    take(s.page_rows, old)[None])
        put(s.psf, old, new_psf[0], ev)
        put(s.hot_hint, old, hint[0], ev)
        put(s.cat, old, False, ev)
        put(s.page_rows, old, 0, ev)
        put(s.page_table, old, -1, ev)

        gp = b * NP + pg.clamp_min(0)
        perm, rows = _ingress_math(cfg, take(s.psf, gp)[None],
                                   take(s.hot_hint, gp)[None],
                                   take(fills, gp)[None])
        src = gp.reshape(1).long()
        kpage = s.k_slab[:, src].index_select(2, perm[0].long())
        vpage = s.v_slab[:, src].index_select(2, perm[0].long())
        dst = torch.where(do, f, F).reshape(1).long()
        s.k_frames[:, dst] = kpage
        s.v_frames[:, dst] = vpage
        put(s.page_table, gp, f, do)
        put(s.page_rows, gp, rows[0], do)
        put(s.frame_page, f, gp, do)
        put(s.cat, gp, False, do)
        put(s.clock, f, s.step, do)
    return s


def fetch_pages(cfg: KVPlaneConfig, s: KVPlaneState, tops: torch.Tensor,
                fills: torch.Tensor, *, mode: str | None = None
                ) -> KVPlaneState:
    """Plan-then-execute ingress for a ``[B, K]`` page selection.
    ``fills`` [B, NP]: appended tokens per page; ``mode`` "batch" or
    "reference" (default ``cfg.fetch_mode``), both replaying one plan."""
    mode = mode or cfg.fetch_mode
    if mode not in ("batch", "reference"):
        raise ValueError(f"unknown fetch mode: {mode!r}")
    plan = plan_fetch(cfg, s, tops)
    if mode == "reference":
        return _exec_fetch_reference(cfg, s, plan, fills)
    return _exec_fetch_batch(cfg, s, plan, fills)


def _select(cfg: KVPlaneConfig, s: KVPlaneState, q, n_valid, newest):
    """The per-sequence top-K page selection: scores from the summaries
    (``page_scores`` over all B*NP pages, then each sequence's slice, as
    JAX computes it), invalid pages at -inf, lowest index first among
    ties, and the append page forced into the last slot if missing.
    ``n_valid`` [B] valid pages; ``newest`` [B] append page (-1 = none)."""
    B, NP, K = cfg.batch, cfg.num_pages, cfg.sparse_topk
    scores = kops.page_scores(q, s.kmax, s.kmin, impl=cfg.kernel_impl)
    per_page = scores.amax(dim=1)                            # [B, B*NP]
    ar = torch.arange(B, device=q.device)
    sl = per_page.view(B, B, NP)[ar, ar]                     # [B, NP]
    valid = _arange(NP, sl)[None] < n_valid[:, None]
    sl = torch.where(valid, sl, -torch.inf)
    _, order = stable_order(sl, descending=True)
    top = order[:, :K]
    top = torch.where(_arange(K, top)[None] < torch.minimum(
        n_valid, torch.full_like(n_valid, K))[:, None], top, -1)
    present = (top == newest[:, None]).any(dim=1) | (newest < 0)
    top[:, K - 1] = torch.where(present, top[:, K - 1], newest)
    return top


def _profile(cfg: KVPlaneConfig, s: KVPlaneState, pages, sel_frames,
             used) -> None:
    """Mark the attended rows' cards and stamp the selected frames'
    clocks (``pages`` [B, K]: the selected page of each valid column).
    Invalid selections write the old values of page 0 and frame 0 back;
    of duplicate targets the last write wins, as in JAX."""
    B, NP, F = cfg.batch, cfg.num_pages, cfg.num_frames
    sel_valid = sel_frames >= 0
    bidx = torch.arange(B, device=pages.device)[:, None]
    touched = (bidx * NP + torch.where(sel_valid, pages, 0)).reshape(-1)
    old_cat = s.cat[touched]
    new_cat = torch.where(sel_valid.reshape(-1, 1),
                          old_cat | used.reshape(-1, used.shape[-1]), old_cat)
    s.cat[_last_wins(touched, B * NP)] = new_cat
    fr = sel_frames.clamp_min(0).reshape(-1)
    new_clock = torch.where(sel_valid.reshape(-1), s.step, s.clock[fr])
    s.clock[_last_wins(fr, F)] = new_clock


def attend_sparse(cfg: KVPlaneConfig, s: KVPlaneState, q, lengths, *,
                  mode: str | None = None):
    """Hybrid sparse decode.  q: [B, H, Dh].  Returns (out [B, H, Dh],
    state)."""
    B, P, NP = cfg.batch, cfg.page_tokens, cfg.num_pages
    s.step = s.step + 1
    # 1. offload-space scoring and top-K selection
    npages = ((lengths + P - 1) // P).clamp_min(1).to(I32)
    tops = _select(cfg, s, q, npages, npages - 1)            # [B, K]
    # 2. ensure-local: one plan for the whole selection
    fills = kops.lengths_to_page_lens(lengths, NP, P)
    fetch_pages(cfg, s, tops, fills, mode=mode)
    # 3. attention over the selected local pages (a -1 selection reads
    #    page NP-1, as JAX's negative index wraps)
    bidx = torch.arange(B, device=q.device)[:, None]
    wrapped = torch.where(tops < 0, tops + NP, tops).long()
    sel_frames = _bn(cfg, s.page_table)[bidx, wrapped]
    sel_valid = sel_frames >= 0
    sel_rows = torch.where(sel_valid, _bn(cfg, s.page_rows)[bidx, wrapped], 0)
    out, used = kops.paged_attention(q, s.k_frames, s.v_frames,
                                     torch.where(sel_valid, sel_frames, -1),
                                     sel_rows, impl=cfg.kernel_impl)
    # 4. always-on profiling
    _profile(cfg, s, wrapped, sel_frames, used)
    return out, s


# --------------------------------------------------------------------------
# window (ring-buffer) mode
# --------------------------------------------------------------------------

def append_window(cfg: KVPlaneConfig, s: KVPlaneState, k_new, v_new, lengths):
    """Ring-buffer append: new tokens overwrite the oldest slot."""
    W = cfg.num_pages * cfg.page_tokens
    return append_dense(cfg, s, k_new, v_new, lengths % W)


def attend_window(cfg: KVPlaneConfig, s: KVPlaneState, q, lengths):
    """Attention over the ring buffer (every slot is inside the window)."""
    W = cfg.num_pages * cfg.page_tokens
    return attend_dense(cfg, s, q, lengths.clamp_max(W))


# --------------------------------------------------------------------------
# sharded sparse decode: shards own disjoint page ranges; partial attention
# per shard, log-sum-exp combine across shards (flash-decoding)
# --------------------------------------------------------------------------

def _attend_pages_partial(q, k_frames, v_frames, table, rows):
    """Unnormalized attention over selected local pages (plain PyTorch, as
    the JAX version is plain jnp).  q [B, H, Dh]; k/v_frames [KVH, F, P,
    Dh]; table/rows [B, K].  Returns (acc [B, H, Dh] f32, m [B, H, 1],
    l [B, H, 1], used [B, K, P] bool)."""
    B, H, Dh = q.shape
    KVH, _, P, _ = k_frames.shape
    K = table.shape[1]
    G = H // KVH
    safe = table.clamp_min(0).long()
    k = k_frames[:, safe].to(torch.float32).permute(1, 0, 2, 3, 4).reshape(
        B, KVH, K * P, Dh)
    v = v_frames[:, safe].to(torch.float32).permute(1, 0, 2, 3, 4).reshape(
        B, KVH, K * P, Dh)
    qg = q.reshape(B, KVH, G, Dh).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=q.device)
    sc = torch.einsum("bkgd,bksd->bkgs", qg, k) * (one / torch.sqrt(
        torch.full((), Dh, dtype=torch.float32, device=q.device)))
    row = torch.arange(P, device=q.device).repeat(K)
    valid = ((row[None] < rows.repeat_interleave(P, dim=1))
             & (table >= 0).repeat_interleave(P, dim=1))      # [B, K*P]
    vm = valid[:, None, None, :]
    sc = torch.where(vm, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v)
    pp = p.reshape(B, KVH, G, K, P)
    mass = pp.sum(dim=-1, keepdim=True)
    used = (pp * P > mass).any(dim=2).any(dim=1) & valid.reshape(B, K, P)
    return (acc.reshape(B, H, Dh), m.reshape(B, H, 1), l.reshape(B, H, 1),
            used)


def attend_sparse_partial(cfg: KVPlaneConfig, s: KVPlaneState, q,
                          first_token, global_len, newest_page, *,
                          mode: str | None = None):
    """One shard's contribution to sharded sparse decode.  ``first_token``:
    absolute position of the shard's first page; ``global_len``: sequence
    length; ``newest_page``: local index of the append page (-1 if another
    shard owns it).  Returns (acc, m, l, state)."""
    B, P, NP = cfg.batch, cfg.page_tokens, cfg.num_pages
    dev = q.device
    s.step = s.step + 1
    page_fill = (global_len - first_token
                 - torch.arange(NP, device=dev) * P).clamp(0, P).to(I32)
    n_valid = (page_fill > 0).sum(dtype=I32)
    newest = torch.as_tensor(newest_page, dtype=I32, device=dev)
    tops = _select(cfg, s, q, n_valid.expand(B), newest.expand(B))
    fetch_pages(cfg, s, tops, page_fill[None].expand(B, NP), mode=mode)
    bidx = torch.arange(B, device=dev)[:, None]
    safe_tops = tops.clamp_min(0).long()
    sel_frames = torch.where(tops >= 0,
                             _bn(cfg, s.page_table)[bidx, safe_tops], -1)
    sel_valid = sel_frames >= 0
    sel_rows = torch.where(sel_valid, _bn(cfg, s.page_rows)[bidx, safe_tops],
                           0)
    acc, m, l, used = _attend_pages_partial(
        q, s.k_frames, s.v_frames, torch.where(sel_valid, sel_frames, -1),
        sel_rows)
    _profile(cfg, s, tops, sel_frames, used)
    return acc, m, l, s


def sharded_sparse_decode(cfg: KVPlaneConfig, states: list, q, lengths, *,
                          mode: str | None = None):
    """Sparse decode over plane shards (a list of states, JAX's leading
    shard axis), one shard after another on one device, with the
    flash-decoding combine.  Returns (out [B, H, Dh], states)."""
    P, NP = cfg.page_tokens, cfg.num_pages
    npages_global = (lengths[0] + P - 1) // P
    newest_global = (npages_global - 1).clamp_min(0)
    accs, ms, ls = [], [], []
    for d, s in enumerate(states):
        newest_local = torch.where(newest_global // NP == d,
                                   newest_global % NP, -1).to(I32)
        acc, m, l, _ = attend_sparse_partial(cfg, s, q, d * NP * P,
                                             lengths[0], newest_local,
                                             mode=mode)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    acc, m, l = torch.stack(accs), torch.stack(ms), torch.stack(ls)
    m_star = m.amax(dim=0, keepdim=True)
    w = torch.exp(m - m_star)
    l_tot = (l * w).sum(dim=0)
    acc_tot = (acc * w).sum(dim=0)
    out = acc_tot / l_tot.clamp_min(1e-30)
    return out.to(q.dtype), states


def append_sharded(cfg: KVPlaneConfig, states: list, k_new, v_new, lengths):
    """Append one token's KV (B=1) into the owning shard's slab page, the
    frame copy if resident, and that page's summaries.  An egress fault
    on the owner's remote write masks the whole append: nothing mutates."""
    D = len(states)
    P, NP = cfg.page_tokens, cfg.num_pages
    t = lengths[0]
    gpage = t // P
    slot = (t % P).reshape(1).long()
    dev = lengths.device
    shard_ids = torch.arange(D, dtype=I32, device=dev)
    own = gpage // NP == shard_ids
    fc = cfg.faults
    if fc is not None and fc.egress_active:
        own = own & ~fc.egress_fail(t, gpage.expand(D), shard_ids)
    gp = (gpage % NP).reshape(1).long()                 # b = 0
    kn = k_new[0].to(cfg.dtype)[:, None]                # [KVH, 1, Dh]
    vn = v_new[0].to(cfg.dtype)[:, None]
    for d, s in enumerate(states):
        owner = own[d]
        s.k_slab[:, gp, slot] = torch.where(owner, kn, s.k_slab[:, gp, slot])
        s.v_slab[:, gp, slot] = torch.where(owner, vn, s.v_slab[:, gp, slot])
        kf = kn.to(torch.float32)
        s.kmax[:, gp] = torch.where(owner, torch.maximum(s.kmax[:, gp], kf),
                                    s.kmax[:, gp])
        s.kmin[:, gp] = torch.where(owner, torch.minimum(s.kmin[:, gp], kf),
                                    s.kmin[:, gp])
        f = s.page_table[gp]
        safe_f = f.clamp_min(0).long()
        do_frame = owner & (f >= 0)
        s.k_frames[:, safe_f, slot] = torch.where(
            do_frame, kn, s.k_frames[:, safe_f, slot])
        s.v_frames[:, safe_f, slot] = torch.where(
            do_frame, vn, s.v_frames[:, safe_f, slot])
        s.page_rows[gp] = torch.where(
            do_frame, torch.maximum(s.page_rows[gp], (slot + 1).to(I32)),
            s.page_rows[gp])
    return states
