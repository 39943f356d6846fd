"""Tiered MoE expert store for decode (port of ``repro.core.expertplane``).

Expert weights are far-memory-shaped state at decode time: a 384-expert
layer activates at most ``batch * topk`` experts per step, routing is
skewed, and the hot set churns.  Each expert is one page (its FFN needs all
of its weights at once), so the plane runs in pure-paging mode: missing
needed experts are fetched in bulk into a hot store of ``hot_slots``
experts, victims are the coldest slots not needed this step, and the MoE
math runs against the hot store through the expert->slot table.

Where the port departs from the JAX form, and why:

* **State in place.**  ``ensure_resident`` and ``moe_decode`` update their
  ``ExpertPlaneState`` in place and return it, keeping JAX's returns.
  ``ExpertPlaneState.clone`` copies a state for an oracle.  JAX's memoized
  jit entries that donate the state need no counterpart.
* **Trash rows.**  JAX drops a scatter at an out-of-bounds index (slot
  ``S``, expert ``E``); here the hot store, ``expert_of`` and ``clock``
  carry a trash slot ``S`` and ``slot_of`` a trash expert ``E`` that take
  such writes.  ``ExpertPlaneState.view`` gives the logical tensors.
* **Ties.**  ``lax.top_k`` takes the lowest index among equals: the fetch
  list (a 0/1 mask, all ties), the victims (equal clocks) and the router's
  top-k all sort stably (``batch.stable_order``), and the dispatch's
  ``jnp.argsort`` is ``torch.argsort(stable=True)``.
* **f32 expert products from bf16 weights** (``preferred_element_type``):
  on the card ``torch.bmm(..., out_dtype=torch.float32)`` reads the bf16
  hot store as it is; the CPU has no such kernel and multiplies f32 copies
  (bf16 products are exact in f32 either way).
* **No ``lax.cond``/``fori_loop``.**  The reference executor runs a static
  trip count of masked updates; nothing on either path syncs with the
  host.
* **On a model mesh** each rank keeps a local plane (its d_model chunk of
  the hot store, a copy of the bookkeeping; see the section below) and
  computes the experts' products on that chunk, as XLA's partitioner
  splits JAX's einsums along the hot store's layout.  The fetch reaches
  the row-copy kernel there too: where the slab's split differs from the
  hot store's (the experts or d_ff split over "model"), the plan's rows
  are exchanged first and the kernel copies them from that exchanged
  pool.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..kernels import ops as kops
from ..launch import mesh as far
from . import state as st
from .batch import stable_order
from .paths import INF32, put, take

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ExpertPlaneConfig:
    n_experts: int          # E
    d_model: int
    d_ff: int
    hot_slots: int          # S: experts resident on the card
    topk: int
    fetch_budget: int = 8   # experts fetched per step
    capacity: int = 0       # tokens per slot buffer (0 -> derive)
    dtype: torch.dtype = torch.bfloat16
    fetch_mode: str = "batch"   # "batch" (vectorized) | "reference" (scalar)
    kernel_impl: str = "auto"   # kernels.ops dispatch for the batched movers
    faults: object = None       # core.faults.Schedule (None = no faults)


# fields with a trash row
_SLOT_AXIS0 = ("hot_wi", "hot_wg", "hot_wo", "expert_of", "clock")  # [S+1]
_EXPERT_AXIS0 = ("slot_of",)                                        # [E+1]


@dataclasses.dataclass(eq=False)
class ExpertPlaneState:
    """Per-layer expert plane state; fields, order and dtypes as the JAX
    ``ExpertPlaneState``, stored with one trash row on each scatter target.
    The canonical far-tier expert weights (the slabs) stay in the params."""

    hot_wi: torch.Tensor     # [S+1, d, f]
    hot_wg: torch.Tensor     # [S+1, d, f]
    hot_wo: torch.Tensor     # [S+1, f, d]
    slot_of: torch.Tensor    # [E+1] int32 (-1 far)
    expert_of: torch.Tensor  # [S+1] int32 (-1 free)
    clock: torch.Tensor      # [S+1] int32
    access: torch.Tensor     # [E] int32 activation counters (profiling)
    step: torch.Tensor       # [] int32

    _fields = ()  # filled below

    def view(self, name: str) -> torch.Tensor:
        """The logical (trash-free) tensor of field ``name``."""
        x = getattr(self, name)
        return x[:-1] if name in _SLOT_AXIS0 + _EXPERT_AXIS0 else x

    def clone(self) -> "ExpertPlaneState":
        return ExpertPlaneState(**{k: getattr(self, k).clone()
                                   for k in self._fields})


ExpertPlaneState._fields = tuple(f.name for f in
                                 dataclasses.fields(ExpertPlaneState))


def init(cfg: ExpertPlaneConfig, device="cuda") -> ExpertPlaneState:
    dev = st.resolve_device(device)
    S, d, f, E = cfg.hot_slots, cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.fetch_budget > S:
        raise ValueError(f"fetch_budget {cfg.fetch_budget} > hot_slots {S}")
    i32 = dict(dtype=I32, device=dev)
    return ExpertPlaneState(
        hot_wi=torch.zeros((S + 1, d, f), dtype=cfg.dtype, device=dev),
        hot_wg=torch.zeros((S + 1, d, f), dtype=cfg.dtype, device=dev),
        hot_wo=torch.zeros((S + 1, f, d), dtype=cfg.dtype, device=dev),
        slot_of=torch.full((E + 1,), -1, **i32),
        expert_of=torch.full((S + 1,), -1, **i32),
        clock=torch.zeros((S + 1,), **i32),
        access=torch.zeros((E,), **i32),
        step=torch.zeros((), **i32),
    )


class ExpertFetchPlan(NamedTuple):
    """Fixed-shape ingress plan for one decode step: one entry per fetch
    budget slot."""
    expert: torch.Tensor  # [budget] int32 expert to fetch (-1 = no-op)
    slot: torch.Tensor    # [budget] int32 destination slot (distinct entries)


def plan_fetch(cfg: ExpertPlaneConfig, s: ExpertPlaneState,
               needed_mask: torch.Tensor) -> ExpertFetchPlan:
    """One vectorized fetch plan: missing needed experts (up to
    ``fetch_budget``, lowest ids first) paired with victim slots from one
    stable sort of the clocks (slots hosting experts needed this step are
    pinned to the end).  A faulted fetch drops out of the plan here: it
    claims no slot and displaces no resident expert."""
    S, B = cfg.hot_slots, cfg.fetch_budget
    missing = needed_mask & (s.view("slot_of") < 0)
    _, fetch_ids = stable_order(missing.to(I32), descending=True)
    fetch_ids = fetch_ids[:B]
    expert = torch.where(missing[fetch_ids], fetch_ids, -1)

    # tick = s.step: moe_decode bumps the step before planning
    fc = cfg.faults
    if fc is not None and fc.active:
        fail = (expert >= 0) & fc.fetch_fail(s.step, expert.clamp_min(0))
        expert = torch.where(fail, -1, expert)

    owner = s.view("expert_of")
    hosted_needed = (owner >= 0) & needed_mask[owner.clamp_min(0)]
    score = torch.where(hosted_needed, INF32, s.view("clock"))
    _, victims = stable_order(score)
    return ExpertFetchPlan(expert=expert, slot=victims[:B])


def _exec_fetch_batch(cfg: ExpertPlaneConfig, s: ExpertPlaneState,
                      plan: ExpertFetchPlan, sources) -> ExpertPlaneState:
    """The plan with batched data movement: every expert's weights arrive
    in ONE ``kernels.gather_rows_into`` call per tensor, written straight
    into its victim slot of the hot store.  ``sources`` gives, for each of
    hot_wi/hot_wg/hot_wo, the row pool and the pool row of each plan entry
    (``_slab_sources``: the slab itself, one expert a row).  Fetched
    experts are missing and displaced ones resident (disjoint ids), victim
    slots distinct.  As in JAX, a -1 entry still gathers expert 0's row,
    which lands in the trash slot (JAX drops it).  The pools must hold the
    hot store's dtype: ``gather_rows_into`` refuses a mismatch."""
    E, S = cfg.n_experts, cfg.hot_slots
    e, slot = plan.expert, plan.slot
    ok = e >= 0
    sdst = torch.where(ok, slot, S)                      # trash slot = drop
    for hot, (pool, idx) in zip((s.hot_wi, s.hot_wg, s.hot_wo), sources):
        kops.gather_rows_into(hot.view(S + 1, -1), sdst, pool, idx,
                              impl=cfg.kernel_impl)
    old = s.expert_of[slot]
    put(s.slot_of, torch.where(ok & (old >= 0), old, E), -1)
    s.slot_of[torch.where(ok, e, E)] = slot
    s.expert_of[sdst] = e
    s.clock[sdst] = s.step
    return s


def _exec_fetch_reference(cfg: ExpertPlaneConfig, s: ExpertPlaneState,
                          plan: ExpertFetchPlan, sources) -> ExpertPlaneState:
    """Scalar oracle: the identical plan one expert at a time, each a
    masked update (a masked-off write lands in a trash row)."""
    S = cfg.hot_slots
    hots = (s.hot_wi, s.hot_wg, s.hot_wo)
    for i in range(cfg.fetch_budget):
        e, slot = plan.expert[i], plan.slot[i]
        do = e >= 0
        old = take(s.expert_of, slot)
        put(s.slot_of, old, -1, do & (old >= 0))
        dst = torch.where(do, slot, S).reshape(1).long()
        for hot, (pool, idx) in zip(hots, sources):
            row = pool.index_select(0, idx[i:i + 1].long())
            hot[dst] = row.view((1,) + tuple(hot.shape[1:])).to(cfg.dtype)
        put(s.slot_of, e, slot, do)
        put(s.expert_of, slot, e, do)
        put(s.clock, slot, s.step, do)
    return s


def _slab_sources(plan: ExpertFetchPlan, slabs) -> list:
    """Each slab as a pool of one expert a row, and each plan entry's
    expert (0 for a -1 entry)."""
    safe_e = plan.expert.clamp_min(0)
    return [(w.reshape(w.shape[0], -1), safe_e) for w in slabs]


def ensure_resident(cfg: ExpertPlaneConfig, s: ExpertPlaneState,
                    needed_mask: torch.Tensor, slab_wi, slab_wg, slab_wo,
                    *, mode: str | None = None, sources=_slab_sources
                    ) -> ExpertPlaneState:
    """Fetch up to ``fetch_budget`` missing needed experts (plan-then-
    execute).  ``mode`` selects the executor ("batch" | "reference",
    default ``cfg.fetch_mode``); both replay the identical plan.
    ``sources(plan, slabs)`` gives the rows the executors copy (on a mesh,
    ``_mesh_sources``)."""
    mode = mode or cfg.fetch_mode
    if mode not in ("batch", "reference"):
        raise ValueError(f"unknown fetch mode: {mode!r}")
    plan = plan_fetch(cfg, s, needed_mask)
    src = sources(plan, (slab_wi, slab_wg, slab_wo))
    if mode == "reference":
        return _exec_fetch_reference(cfg, s, plan, src)
    return _exec_fetch_batch(cfg, s, plan, src)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with an f32 result (``preferred_element_type=
    f32``), without an f32 copy of ``b`` on the card."""
    if a.device.type in ("cpu", "meta") or a.dtype == torch.float32:
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))
    return torch.bmm(a, b, out_dtype=torch.float32)


def moe_decode(cfg: ExpertPlaneConfig, s: ExpertPlaneState, router,
               x: torch.Tensor, slab_wi, slab_wg, slab_wo,
               *, mode: str | None = None):
    """x: [T, d] decode-token activations; router: [d, E].
    Returns (y [T, d], state).  Tokens whose expert could not be made
    resident within the fetch budget are dropped for that expert (their
    gate weight is re-normalized away); so are tokens past a slot's
    capacity.  On a current model mesh with ``x`` a DTensor, ``s`` is this
    rank's local plane (``local_plane``) and the step runs as
    ``_moe_decode_mesh`` says."""
    slabs = (slab_wi, slab_wg, slab_wo)
    mesh = far.current_mesh()
    if mesh is not None and isinstance(x, DTensor):
        return _moe_decode_mesh(cfg, mesh, s, router, x, slabs, mode)
    y = _moe(cfg, s, router, x, x, slabs, mode, _slab_sources,
             lambda t: t)
    return y, s


def _moe(cfg: ExpertPlaneConfig, s: ExpertPlaneState, router, x, xd, slabs,
         mode, sources, reduce) -> torch.Tensor:
    """The step on plain tensors: route the tokens ``x`` [T, d], fetch
    (``ensure_resident`` with ``sources``), dispatch the columns ``xd``
    [T, d'] of the tokens by slot (``x`` itself, or on a mesh this rank's
    d_model chunk, the hot store's), the experts' products (``_experts``,
    their partial sums through ``reduce``), combine: y [T, d']."""
    T, d = x.shape
    E, S, K = cfg.n_experts, cfg.hot_slots, cfg.topk
    C = cfg.capacity or max(8, -(-T * K * 2 // S))
    dev = x.device
    s.step = s.step + 1

    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = stable_order(probs, descending=True)
    gate, expert = gate[:, :K], expert[:, :K]                 # [T, K]

    flat_e = expert.reshape(-1)
    needed = torch.zeros((E,), dtype=torch.bool, device=dev)
    put(needed, flat_e, True)
    ensure_resident(cfg, s, needed, *slabs, mode=mode, sources=sources)
    s.access += needed.to(I32)
    owner = s.view("expert_of")
    hosted = (owner >= 0) & needed[owner.clamp_min(0)]
    s.view("clock").copy_(torch.where(hosted, s.step, s.view("clock")))

    # dispatch by SLOT (smart-pointer indirection into the hot store)
    slot = s.slot_of[flat_e]                                  # [T*K] (-1 dropped)
    key = torch.where(slot >= 0, slot, S)
    sort_idx = torch.argsort(key, stable=True)
    sorted_slot = key[sort_idx]
    pos = torch.arange(T * K, dtype=I32, device=dev)
    seg_start = torch.full((S + 1,), T * K, dtype=I32, device=dev)
    seg_start.scatter_reduce_(0, sorted_slot.long(), pos, "amin")
    rank_sorted = pos - seg_start[sorted_slot]
    rank = torch.empty_like(pos).scatter_(0, sort_idx, rank_sorted)
    keep = (slot >= 0) & (rank < C)
    dst = torch.where(keep, slot * C + rank, S * C)

    dc = xd.shape[1]
    xe = torch.zeros((S * C + 1, dc), dtype=cfg.dtype, device=dev)
    xe[dst] = xd.to(cfg.dtype).repeat_interleave(K, dim=0)
    ye = _experts(cfg, s, xe[:-1].view(S, C, dc), reduce)
    ye = torch.cat([ye.reshape(S * C, dc),
                    torch.zeros((1, dc), dtype=cfg.dtype, device=dev)])

    yt = ye[dst].view(T, K, dc).to(torch.float32)
    w = torch.where(keep.view(T, K), gate, 0.0)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    y = torch.einsum("tkd,tk->td", yt, w)
    return y.to(x.dtype)


def _experts(cfg: ExpertPlaneConfig, s: ExpertPlaneState, xe, reduce):
    """The hot store's SwiGLU on the dispatched tokens xe [S, C, d'] (d'
    the hot store's d_model, whole or this rank's chunk): g and i in f32,
    each summed by ``reduce`` (over the ranks that hold the other chunks
    of d_model, or nothing), then ye [S, C, d'] in ``cfg.dtype``."""
    S = cfg.hot_slots
    g = reduce(_bmm_f32(xe, s.hot_wg[:S]))
    i = reduce(_bmm_f32(xe, s.hot_wi[:S]))
    h = (torch.nn.functional.silu(g) * i).to(cfg.dtype)
    return _bmm_f32(h, s.hot_wo[:S]).to(cfg.dtype)


# --------------------------------------------------------------------------
# the plane on a model mesh (launch.mesh)
# --------------------------------------------------------------------------
# JAX lays the hot store out as (None, dp, None) for hot_wi/hot_wg and
# (None, None, dp) for hot_wo (d_model split over dp) with the bookkeeping
# replicated.  Here each rank keeps a local plane: its chunk of d_model of
# the hot store (rank r of dp's n ranks holds [r*d/n, (r+1)*d/n)) and a
# whole copy of the bookkeeping; the step computes on that chunk.

_SPLIT_DIM = {"hot_wi": 1, "hot_wg": 1, "hot_wo": 2}


def local_plane(s: ExpertPlaneState, r: int, n: int) -> ExpertPlaneState:
    """Rank ``r``'s plane of ``n`` dp ranks: its d_model chunk of the hot
    store, a copy of the bookkeeping.  A new state (shares no storage with
    ``s``)."""
    out = {}
    for k in ExpertPlaneState._fields:
        x = getattr(s, k)
        if k in _SPLIT_DIM:
            dim = _SPLIT_DIM[k]
            if x.shape[dim] % n:
                raise ValueError(f"d_model {x.shape[dim]} does not split "
                                 f"evenly over {n} data-parallel ranks")
            c = x.shape[dim] // n
            x = x.narrow(dim, r * c, c)
        out[k] = x.clone(memory_format=torch.contiguous_format)
    return ExpertPlaneState(**out)


def concat_planes(planes: list) -> ExpertPlaneState:
    """The whole plane from the ranks' local planes in dp order (the
    inverse of ``local_plane``; the bookkeeping is rank 0's)."""
    return ExpertPlaneState(**{
        k: (torch.cat([getattr(p, k) for p in planes], _SPLIT_DIM[k])
            if k in _SPLIT_DIM else getattr(planes[0], k).clone())
        for k in ExpertPlaneState._fields})


def _hot_placements(mesh) -> list:
    return [far.placements(mesh, (None, "dp", None)),
            far.placements(mesh, (None, "dp", None)),
            far.placements(mesh, (None, None, "dp"))]


def _mesh_sources(mesh, hot_pls):
    """The rows of a fetch on a mesh, in the layout of this rank's local
    hot store.  Where the slab's local shard holds the same chunk of every
    expert as the hot store (every mesh axis of more than one rank splits
    both alike: always on a (1, 1) mesh) the slab's local shard is the
    pool, as on the plain path.  Otherwise (the experts or d_ff split over
    "model") the plan's rows are exchanged first: each rank takes the
    rows it holds (zero elsewhere), and a redistribution to the hot
    store's layout sums the expert split and gathers the d_ff split; the
    copy into the hot store then takes those rows as its pool.  Either way
    the copy is ``gather_rows_into``, the row-copy kernel on the card."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def sources(plan, slabs):
        safe_e = plan.expert.clamp_min(0)
        out = []
        for w, hp in zip(slabs, hot_pls):
            local = w.to_local()
            if all(p == q for p, q, n in zip(w.placements, hp, mesh.shape)
                   if n > 1):
                out.append((local.reshape(local.shape[0], -1), safe_e))
                continue
            shape, offset = compute_local_shape_and_global_offset(
                w.shape, mesh, w.placements)
            lo, cnt = offset[0], shape[0]
            rows = local[(safe_e - lo).clamp(0, max(cnt - 1, 0)).long()]
            if cnt != w.shape[0]:
                mine = (safe_e >= lo) & (safe_e < lo + cnt)
                rows = torch.where(mine.view((-1,) + (1,) * (rows.ndim - 1)),
                                   rows, torch.zeros_like(rows))
            pl = [Partial() if isinstance(p, Shard) and p.dim == 0 else p
                  for p in w.placements]
            full = (safe_e.shape[0],) + tuple(w.shape[1:])
            rows = DTensor.from_local(
                rows, mesh, pl, shape=torch.Size(full),
                stride=torch.empty(full, device="meta").stride())
            rows = rows.redistribute(mesh, hp).to_local()
            out.append((rows.reshape(rows.shape[0], -1),
                        torch.arange(rows.shape[0], dtype=I32,
                                     device=rows.device)))
        return out
    return sources


def _moe_decode_mesh(cfg: ExpertPlaneConfig, mesh, s: ExpertPlaneState,
                     router, x, slabs, mode):
    """The step on a model mesh, as XLA's partitioner splits JAX's step
    along the hot store's layout: the tokens (split over dp) and the router
    gathered whole, so every rank plans the same fetch on its copy of the
    bookkeeping; the fetch writes each rank's chunk of the rows
    (``_mesh_sources``); each rank dispatches its d_model chunk of the
    tokens and computes the products on its chunk of the hot store, g and
    i as partial sums all-reduced over dp, ye and the combine as its chunk
    of d_model; the result is laid out as ``x``.  No rank holds the whole
    hot store."""
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * mesh.ndim
    xr = x.redistribute(mesh, rep).to_local()
    rr = router.redistribute(mesh, rep).to_local()
    r, _ = far.coordinate(mesh, "dp")
    c = s.hot_wi.shape[1]
    y = _moe(cfg, s, rr, xr, xr[:, r * c:(r + 1) * c], slabs, mode,
             _mesh_sources(mesh, _hot_placements(mesh)),
             lambda t: far.all_reduce(t, mesh, "dp"))
    T, d = xr.shape
    y = DTensor.from_local(y, mesh, far.placements(mesh, (None, "dp")),
                           shape=torch.Size((T, d)), stride=(d, 1))
    return y.redistribute(mesh, x.placements), s
