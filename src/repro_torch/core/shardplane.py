"""Sharded far tier: the hybrid data plane partitioned over a ``far`` axis
(port of ``repro.core.shardplane``).

Shard ``s`` owns global objects ``[s*O, (s+1)*O)`` (``O`` per shard): a
contiguous slab partition, its own frame pool, CAT/CAR/EMA profiling state
and governor threshold, a whole per-shard ``PlaneState``.  A sharded state
is a list of those (JAX's leading shard axis, ``state.create_sharded``).

Access is a fixed-shape, round-based exchange:

  1. **Pack** (per source shard): dedup the pending ids in first-appearance
     order, bucket them by owner (``id // O``: objects never leave their
     owner's partition), and take the first ``per_shard_budget`` per
     destination; the rest **spill** to the next round (counted in
     ``stats.ingress_spills``).  A duplicate multiplicity rides along, so
     the owner credits the collapsed requests as hits, as the single plane
     does.
  2. **all-to-all**: the ``[S, B]`` id buffers go from source-major to
     destination-major.
  3. **Serve** (per owner): local ids through the single-device
     plan-then-execute engine (``core.batch`` and its kernels) against the
     owner's own partition; padded slots are negative-id no-ops.
  4. **all-to-all**: the rows (and the fault model's ``served`` verdicts)
     return to their requesters, which scatter them into request order.

``rounds = ceil(shard_batch / per_shard_budget)`` is static, so every
request is served within one call however skewed the batch.  Two exchange
schedules compute the same values: ``"serial"`` (pack, ids, counts, serve,
rows, strictly in turn) and ``"overlap"`` (ids+counts and rows+flags fused
into one payload a direction by ``kernels.ops.fuse_*``, and the rounds
software-pipelined: round r+1's pack and ingress are issued before round
r's serve, with a one-round prologue and epilogue and a depth-2 return
buffer whose first, all -1, collect changes nothing).  ``advance_epoch``
hands every shard the same global ``(d_page, d_obj)`` traffic, summed over
the shards in a fixed order, so the thresholds move in lockstep.

Every phase is one plain per-shard function, and the two schedules are
written once and given their phases and their collective as closures:

* ``group=None`` (the ``jitted_*`` entry points) or the module-level
  ``access``/``update``/``advance_epoch``/``evacuate``: the **loop
  oracle** on one device.  Each shard is one step of a Python loop, and
  the all-to-all is a transpose of the stacked ``[S(src), S(dst), ...]``
  buffers, as JAX's ``mesh=None`` ``vmap`` oracle swaps its axes.
* a process group (``launch.mesh``, one rank a shard): the **mesh path**.
  Each rank runs the same schedule on its own shard; the all-to-all is
  ``dist.all_to_all_single`` with equal splits (source-major, as
  ``lax.all_to_all(split_axis=0, concat_axis=0)``), the epoch an
  ``all_gather`` and the same fixed-order sum.  Only int32, uint8 and the
  row dtype go on the wire (a bool crosses as uint8).  The states are
  those of ``launch.mesh.put_far`` (this rank's shard, ``None`` for the
  others), ``ids`` the global ``[S, R]`` batch on every rank, and the
  rows returned are this rank's block ``[R, D]`` (JAX's global array,
  sharded; ``launch.mesh.gather_shards`` reads it whole).

Where JAX and PyTorch differ, this port reproduces JAX on purpose: the
``.at[dst, slot].set`` whose ``dst == S`` is dropped lands in a trash row
``S`` here; ``jnp.argmax`` over a bool match (the first True) and the
last-writer ``max(where(match, i, -1))`` are spelled out; the epoch total
is summed left to right over the shards in float32.  The states update in
place, as everywhere in the port; nothing here syncs with the host except
the object plane's reclaim reads, ``stats_total``/``paging_fraction`` when
read, and ``check_invariants``.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
import torch.distributed as dist

from ..kernels import ops as kops
from ..launch import mesh as far
from . import baselines
from . import batch as batch_lib
from . import plane as plane_lib
from . import state as st
from .layout import FREE, PlaneConfig

I32 = torch.int32


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlaneConfig:
    """Static description of a sharded plane (same fields as JAX).
    ``shard`` is the PER-SHARD plane config; the global object space is
    ``shards * shard.num_objs`` ids, owner-major."""

    shard: PlaneConfig
    shards: int                 # S: size of the far axis
    shard_batch: int            # R: requests per shard per access call
    per_shard_budget: int       # B: ids exchanged per (src, dst) per round
    plane: str = "hybrid"       # hybrid | paging | object
    exchange: str = "overlap"   # "overlap" pipelined 2-hop | "serial" 3-hop

    def __post_init__(self):
        assert self.shards >= 1
        assert self.shard_batch >= 1
        assert 1 <= self.per_shard_budget <= self.shard_batch
        assert self.plane in ("hybrid", "paging", "object"), self.plane
        assert self.exchange in ("overlap", "serial"), self.exchange

    @property
    def rounds(self) -> int:
        """ceil(R/B): enough rounds even if every id targets one owner."""
        return -(-self.shard_batch // self.per_shard_budget)

    @property
    def num_objs(self) -> int:
        return self.shards * self.shard.num_objs


def shard_config(cfg: PlaneConfig, shards: int) -> PlaneConfig:
    """Slice a GLOBAL plane config into the per-shard config: objects,
    frames and vpages divide evenly across shards (asserted)."""
    for field, n in (("num_objs", cfg.num_objs),
                     ("num_frames", cfg.num_frames),
                     ("num_vpages", cfg.num_vpages)):
        assert n % shards == 0, (
            f"{field}={n} must divide evenly across {shards} shards")
    return dataclasses.replace(cfg, num_objs=cfg.num_objs // shards,
                               num_frames=cfg.num_frames // shards,
                               num_vpages=cfg.num_vpages // shards)


def make_config(cfg: PlaneConfig, shards: int, shard_batch: int,
                per_shard_budget: int | None = None,
                plane: str = "hybrid",
                exchange: str = "overlap") -> ShardedPlaneConfig:
    """A sharded config from a GLOBAL plane config.  The default budget
    (= ``shard_batch``) gives one exchange round and no spills."""
    return ShardedPlaneConfig(
        shard=shard_config(cfg, shards), shards=shards,
        shard_batch=shard_batch,
        per_shard_budget=per_shard_budget or shard_batch, plane=plane,
        exchange=exchange)


def create(cfg: ShardedPlaneConfig, initial, device="cuda") -> list:
    """The per-shard states over the global ``[S*O, D]`` objects."""
    return st.create_sharded(cfg.shard, cfg.shards, initial, device)


# --------------------------------------------------------------------------
# per-shard phases (shared by the loop oracle and the mesh path)
# --------------------------------------------------------------------------

def _first_match(match: torch.Tensor):
    """``(jnp.argmax(match, -1), jnp.any(match, -1))`` for a bool match:
    the index of the first True (0 where there is none)."""
    n = match.shape[-1]
    i = torch.arange(n, dtype=I32, device=match.device)
    hit = match.any(dim=-1)
    j = torch.where(match, i, n).amin(dim=-1)
    return torch.where(hit, j, 0), hit


def _pack_round(cfg: ShardedPlaneConfig, ids, todo):
    """One shard's send buffers for one round.  ``ids [R]`` global object
    ids (< 0 = padding); ``todo [R]`` marks requests not yet served.
    Returns ``(send [S, B] ids (-1 pad), cnt [S, B] duplicate
    multiplicity, todo' [R], n_spill [])``."""
    S, B, R = cfg.shards, cfg.per_shard_budget, cfg.shard_batch
    first = batch_lib._first_of(ids, todo)
    owner = torch.where(first, ids // cfg.shard.num_objs, S)
    i = torch.arange(R, dtype=I32, device=ids.device)
    ahead = ((owner[None, :] == owner[:, None]) & first[None, :]
             & (i[None, :] < i[:, None]))
    rank = ahead.sum(dim=1, dtype=I32)                # per-destination rank
    sent = first & (rank < B)
    dst = torch.where(sent, owner, S)                 # row S = trash (drop)
    slot = torch.where(sent, rank, 0)
    send = torch.full((S + 1, B), -1, dtype=I32, device=ids.device)
    send[dst, slot] = ids
    send = send[:S]
    flat = send.reshape(S * B)
    # duplicate multiplicity: how many pending requests each sent id covers
    cnt = ((flat[:, None] == ids[None, :]) & todo[None, :]).sum(dim=1,
                                                                dtype=I32)
    cnt = torch.where(flat >= 0, cnt, 0).reshape(S, B)
    served = ((ids[:, None] == flat[None, :]) & (flat[None, :] >= 0)).any(
        dim=1)
    n_spill = (first & ~sent).sum(dtype=I32)
    return send, cnt, todo & ~served, n_spill


def _serve_round(cfg: ShardedPlaneConfig, s, recv, recv_cnt, me, *, mode,
                 degraded=False, reclaim=None):
    """Serve one round's received ids (``recv/recv_cnt [S, B]``,
    destination-major) against this shard's own plane; ``me`` is the
    shard's index and keys the fault model's per-shard streams.  Returns
    ``(state, rows [S, B, D], served [S, B])``, row block ``j`` answering
    source shard ``j``.  ``reclaim`` is the object plane's reclaim loop
    (``baselines.object_reclaim`` by default)."""
    S, B, D = cfg.shards, cfg.per_shard_budget, cfg.shard.obj_dim
    ok = recv >= 0
    lids = torch.where(ok, recv - me * cfg.shard.num_objs, -1).reshape(S * B)
    if cfg.plane == "hybrid":
        plan = batch_lib.plan_access(cfg.shard, s, lids, shard=me,
                                     degraded=degraded)
        s, rows = batch_lib.execute_access(cfg.shard, s, lids, plan,
                                           mode=mode)
    elif cfg.plane == "paging":
        plan = batch_lib.plan_access(cfg.shard, s, lids, split_by_psf=False,
                                     shard=me, degraded=degraded)
        s, rows = batch_lib.execute_paging_access(cfg.shard, s, lids, plan,
                                                  mode=mode)
    else:
        plan = batch_lib.plan_access(cfg.shard, s, lids, all_runtime=True,
                                     shard=me, degraded=degraded)
        s, rows = batch_lib.execute_object_access(
            cfg.shard, s, lids, plan, mode=mode,
            reclaim=reclaim or baselines.object_reclaim)
    extra = torch.where(ok, recv_cnt - 1, 0).sum(dtype=I32)
    st.bump(s.stats, hits=extra)
    return s, rows.reshape(S, B, D), plan.served.reshape(S, B)


def _collect_round(cfg: ShardedPlaneConfig, out, ids, send, got):
    """Scatter one round's returned rows (``got [S, B, D]``, the rows of
    the ids this shard sent, ``send [S, B]``) into request order; requests
    served in earlier rounds match nothing and keep their value."""
    S, B, D = cfg.shards, cfg.per_shard_budget, cfg.shard.obj_dim
    flat = send.reshape(S * B)
    match = (ids[:, None] == flat[None, :]) & (flat[None, :] >= 0)
    j, hit = _first_match(match)
    return torch.where(hit[:, None], got.reshape(S * B, D)[j], out)


def _collect_served(cfg: ShardedPlaneConfig, out, ids, send, got):
    """The served-flag analogue of ``_collect_round``: duplicates of a
    sent id all take the owner's verdict."""
    S, B = cfg.shards, cfg.per_shard_budget
    flat = send.reshape(S * B)
    match = (ids[:, None] == flat[None, :]) & (flat[None, :] >= 0)
    j, hit = _first_match(match)
    return torch.where(hit, got.reshape(S * B)[j], out)


def _pack_payload(cfg: ShardedPlaneConfig, ids, rows, send):
    """Update payload for one round's send buffer: the LAST-occurrence row
    of each sent id (the single plane's last-write-wins dedup)."""
    S, B, R = cfg.shards, cfg.per_shard_budget, cfg.shard_batch
    flat = send.reshape(S * B)
    i = torch.arange(R, dtype=I32, device=ids.device)
    match = (flat[:, None] == ids[None, :]) & (flat[:, None] >= 0)
    j = torch.where(match, i[None, :], -1).amax(dim=1)
    payload = torch.where((j >= 0)[:, None], rows[j.clamp(0, R - 1)], 0)
    return payload.reshape(S, B, -1).to(cfg.shard.dtype)


def _serve_update_round(cfg: ShardedPlaneConfig, s, recv, recv_cnt, payload,
                        me, *, mode):
    """Apply one round's received writes to this shard's own plane (the
    plan-then-execute split of ``_serve_round``)."""
    S, B, D = cfg.shards, cfg.per_shard_budget, cfg.shard.obj_dim
    ok = recv >= 0
    lids = torch.where(ok, recv - me * cfg.shard.num_objs, -1).reshape(S * B)
    plan = batch_lib.plan_access(cfg.shard, s, lids, shard=me,
                                 for_update=True)
    s = batch_lib.execute_update(cfg.shard, s, lids,
                                 payload.reshape(S * B, D), plan, mode=mode)
    st.bump(s.stats, hits=torch.where(ok, recv_cnt - 1, 0).sum(dtype=I32))
    return s


def _epoch_traffic(cfg: PlaneConfig, s) -> torch.Tensor:
    """One shard's ``[d_page_bytes, d_obj_bytes]`` (f32) since its last
    epoch."""
    d_page = ((s.stats.page_ins - s.epoch_page_ins).to(torch.float32)
              * cfg.page_bytes)
    d_obj = ((s.stats.obj_ins - s.epoch_obj_ins).to(torch.float32)
             * cfg.row_bytes)
    return torch.stack([d_page, d_obj])


def shard_sum(d: torch.Tensor) -> torch.Tensor:
    """Sum over the leading shard axis, left to right in ``d``'s dtype:
    the fixed order of the JAX oracle's ``jnp.sum(d, axis=0)``."""
    tot = d[0]
    for k in range(1, d.shape[0]):
        tot = tot + d[k]
    return tot


def _bump_spills(states, spills):
    """Add each shard's spill count: a list of states with ``spills [S]``
    (the oracle), or one state with a 0-d count (the mesh path)."""
    if isinstance(states, list):
        for s, n in zip(states, spills):
            st.bump(s.stats, ingress_spills=n)
    else:
        st.bump(states.stats, ingress_spills=spills)
    return states


# --------------------------------------------------------------------------
# round schedules (written ONCE; the oracle and the mesh path give them
# their phase closures and their collective)
# --------------------------------------------------------------------------

def _sched_access(cfg: ShardedPlaneConfig, states, ids, *, pack, serve,
                  collect, collect_sv, a2a, with_served):
    """Every exchange round of one access call.

    ``pack(ids, todo) -> (send, cnt, todo', n_spill)``;
    ``serve(states, recv, recv_cnt) -> (states, rows, served)``;
    ``collect(out, ids, send, rows) -> out``;
    ``collect_sv(out_sv, ids, send, served) -> out_sv``;
    ``a2a`` is the direction transpose.  Leading dims come from ``ids``
    (``[S, R]`` oracle, ``[R]`` per shard), so the same code serves both."""
    S, B = cfg.shards, cfg.per_shard_budget
    R, D = cfg.shard_batch, cfg.shard.obj_dim
    lead, dev = tuple(ids.shape[:-1]), ids.device
    todo = ids >= 0
    out = torch.zeros(lead + (R, D), dtype=cfg.shard.dtype, device=dev)
    out_sv = torch.zeros(lead + (R,), dtype=torch.bool, device=dev)
    spills = torch.zeros(lead, dtype=I32, device=dev)

    if cfg.exchange == "serial":
        for _ in range(cfg.rounds):
            send, cnt, todo, nsp = pack(ids, todo)
            spills = spills + nsp
            states, rows, sv = serve(states, a2a(send), a2a(cnt))
            out = collect(out, ids, send, a2a(rows))
            if with_served:
                out_sv = collect_sv(out_sv, ids, send, a2a(sv))
        return _bump_spills(states, spills), out, out_sv

    # -- overlap: fused payloads + software-pipelined rounds ---------------
    def serve_f(states, ing):
        recv, recv_cnt = kops.split_ids_counts(ing)
        states, rows, sv = serve(states, recv, recv_cnt)
        return states, kops.fuse_rows_flags(rows, sv)

    def collect_f(out, out_sv, send, ret):
        rows, sv = kops.split_rows_flags(ret)
        out = collect(out, ids, send, rows)
        if with_served:
            out_sv = collect_sv(out_sv, ids, send, sv)
        return out, out_sv

    # prologue: round 0's ingress is on the wire before any serve runs
    send, cnt, todo, nsp = pack(ids, todo)
    spills = spills + nsp
    ing = a2a(kops.fuse_ids_counts(send, cnt))
    # depth-2 return buffer; the all -1 dummy send matches no request
    prev_send = torch.full(lead + (S, B), -1, dtype=I32, device=dev)
    prev_ret = torch.zeros(lead + (S, B, D + 1), dtype=cfg.shard.dtype,
                           device=dev)
    for _ in range(cfg.rounds - 1):
        # round r+1's pack + ingress first: it depends only on the ids
        n_send, n_cnt, todo, nsp = pack(ids, todo)
        spills = spills + nsp
        n_ing = a2a(kops.fuse_ids_counts(n_send, n_cnt))
        states, ret = serve_f(states, ing)
        ret = a2a(ret)                  # collected on the next trip
        out, out_sv = collect_f(out, out_sv, prev_send, prev_ret)
        send, ing, prev_send, prev_ret = n_send, n_ing, send, ret
    # epilogue: serve the last round, then drain both outstanding returns
    states, ret = serve_f(states, ing)
    ret = a2a(ret)
    out, out_sv = collect_f(out, out_sv, prev_send, prev_ret)
    out, out_sv = collect_f(out, out_sv, send, ret)
    return _bump_spills(states, spills), out, out_sv


def _sched_update(cfg: ShardedPlaneConfig, states, ids, rows, *, pack,
                  payload_of, serve, a2a):
    """Write-through rounds: the two schedules of ``_sched_access`` minus
    the egress leg.  Overlap moves two collectives a round, the fused
    ids+counts and the row payload (int32 ids do not ride bit-safely in a
    bf16 row buffer)."""
    lead, dev = tuple(ids.shape[:-1]), ids.device
    todo = ids >= 0
    spills = torch.zeros(lead, dtype=I32, device=dev)

    if cfg.exchange == "serial":
        for _ in range(cfg.rounds):
            send, cnt, todo, nsp = pack(ids, todo)
            spills = spills + nsp
            payload = payload_of(ids, rows, send)
            states = serve(states, a2a(send), a2a(cnt), a2a(payload))
        return _bump_spills(states, spills)

    def serve_f(states, ing, pay):
        recv, recv_cnt = kops.split_ids_counts(ing)
        return serve(states, recv, recv_cnt, pay)

    send, cnt, todo, nsp = pack(ids, todo)
    spills = spills + nsp
    ing = a2a(kops.fuse_ids_counts(send, cnt))
    pay = a2a(payload_of(ids, rows, send))
    for _ in range(cfg.rounds - 1):
        n_send, n_cnt, todo, nsp = pack(ids, todo)
        spills = spills + nsp
        n_ing = a2a(kops.fuse_ids_counts(n_send, n_cnt))
        n_pay = a2a(payload_of(ids, rows, n_send))
        states = serve_f(states, ing, pay)
        ing, pay = n_ing, n_pay
    states = serve_f(states, ing, pay)
    return _bump_spills(states, spills)


# --------------------------------------------------------------------------
# the loop oracle: one device, each shard a step of a Python loop, the
# all-to-all a transpose of the stacked buffers
# --------------------------------------------------------------------------

def _stacked(fn, S: int):
    """A per-shard phase over stacked arguments: shard ``k`` gets the k-th
    slice of each, and the results are stacked again (JAX's ``vmap``)."""
    def run(*args):
        outs = [fn(*(a[k] for a in args)) for k in range(S)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(x) for x in zip(*outs))
        return torch.stack(outs)
    return run


def _swap(x: torch.Tensor) -> torch.Tensor:
    """The emulated all-to-all: [S(src), S(dst), ...] -> [S(dst), S(src),
    ...]."""
    return x.transpose(0, 1).contiguous()


def _per_shard(x, k: int):
    """Shard ``k``'s entry of a per-shard argument (``None``, a bool or
    one value for every shard stay as they are)."""
    return x[k] if isinstance(x, (list, tuple, torch.Tensor)) else x


def _degraded_arg(degraded, device):
    """``degraded`` as a bool (every shard alike, a static plan) or an
    ``[S]`` bool tensor (the per-shard breaker's mask, as data)."""
    if isinstance(degraded, bool):
        return degraded
    return torch.as_tensor(degraded, device=device).to(torch.bool)


def access(cfg: ShardedPlaneConfig, states: list, ids, *, mode=None,
           degraded=False, with_served: bool = False, reclaim=None):
    """Sharded access on ONE device (the bit-equivalence oracle).

    ``states`` is the list of per-shard states; ``ids [S, R]`` global
    object ids per source shard (< 0 = padding).  Returns ``(states,
    rows [S, R, D])`` in request order, plus ``served [S, R]`` when
    ``with_served`` (the fault model's verdicts, back with the rows).

    ``degraded`` is a bool (every shard degraded, the global breaker) or
    an ``[S]`` bool mask (the per-shard breaker): a masked shard plans no
    remote I/O and serves local hits only, while the others run the full
    path bit-identically to their all-healthy oracle.  ``reclaim``
    optionally gives the object plane's reclaim loop of each shard."""
    S = cfg.shards
    deg = _degraded_arg(degraded, ids.device)

    def serve(states, recv, cnt):
        rows, sv = [], []
        for k in range(S):
            states[k], r, v = _serve_round(
                cfg, states[k], recv[k], cnt[k], k, mode=mode,
                degraded=_per_shard(deg, k),
                reclaim=_per_shard(reclaim, k))
            rows.append(r)
            sv.append(v)
        return states, torch.stack(rows), torch.stack(sv)

    states, out, out_sv = _sched_access(
        cfg, states, ids,
        pack=_stacked(partial(_pack_round, cfg), S), serve=serve,
        collect=_stacked(partial(_collect_round, cfg), S),
        collect_sv=_stacked(partial(_collect_served, cfg), S),
        a2a=_swap, with_served=with_served)
    return (states, out, out_sv) if with_served else (states, out)


def update(cfg: ShardedPlaneConfig, states: list, ids, rows, *, mode=None):
    """Sharded write-through on ONE device (oracle).  ``rows [S, R, D]``."""
    if cfg.plane != "hybrid":
        raise ValueError("sharded update is a hybrid-plane operation")

    def serve(states, recv, cnt, pay):
        for k in range(cfg.shards):
            states[k] = _serve_update_round(cfg, states[k], recv[k], cnt[k],
                                            pay[k], k, mode=mode)
        return states

    return _sched_update(
        cfg, states, ids, rows,
        pack=_stacked(partial(_pack_round, cfg), cfg.shards),
        payload_of=_stacked(partial(_pack_payload, cfg), cfg.shards),
        serve=serve, a2a=_swap)


def advance_epoch(cfg: ShardedPlaneConfig, states: list) -> list:
    """Close one epoch on every shard with the GLOBAL traffic aggregate
    (one device; the fixed-order sum of the mesh path's all_gather)."""
    tot = shard_sum(torch.stack([_epoch_traffic(cfg.shard, s)
                                  for s in states]))
    for s in states:
        plane_lib.advance_epoch(cfg.shard, s, traffic=(tot[0], tot[1]))
    return states


def evacuate(cfg: ShardedPlaneConfig, states: list, garbage_threshold=None,
             max_pages: int = 16, *, clear_access: bool = True) -> list:
    """Per-shard compaction (objects re-pack onto their owner's own fill
    pages: no cross-shard traffic); shard ``k`` keys the fault model's
    egress stream with ``k``."""
    for k, s in enumerate(states):
        plane_lib.evacuate(cfg.shard, s, garbage_threshold=garbage_threshold,
                           max_pages=max_pages, clear_access=clear_access,
                           shard=k)
    return states


# --------------------------------------------------------------------------
# the mesh path: one rank a shard, the same schedules, torch.distributed
# --------------------------------------------------------------------------

def _mesh_access(cfg: ShardedPlaneConfig, group, mode, with_served,
                 reclaim, states, ids, degraded=False):
    me = dist.get_rank(group)
    s = states[me]
    ids = ids.to(s.device)[me]
    d = _per_shard(_degraded_arg(degraded, s.device), me)
    s, out, out_sv = _sched_access(
        cfg, s, ids, pack=partial(_pack_round, cfg),
        serve=lambda st_, recv, cnt: _serve_round(
            cfg, st_, recv, cnt, me, mode=mode, degraded=d,
            reclaim=_per_shard(reclaim, me)),
        collect=partial(_collect_round, cfg),
        collect_sv=partial(_collect_served, cfg),
        a2a=partial(far.all_to_all, group), with_served=with_served)
    states[me] = s
    return (states, out, out_sv) if with_served else (states, out)


def _mesh_update(cfg: ShardedPlaneConfig, group, mode, states, ids, rows):
    me = dist.get_rank(group)
    s = states[me]
    states[me] = _sched_update(
        cfg, s, ids.to(s.device)[me], rows.to(s.device)[me],
        pack=partial(_pack_round, cfg),
        payload_of=partial(_pack_payload, cfg),
        serve=lambda st_, recv, cnt, pay: _serve_update_round(
            cfg, st_, recv, cnt, pay, me, mode=mode),
        a2a=partial(far.all_to_all, group))
    return states


def _mesh_epoch(cfg: ShardedPlaneConfig, group, states):
    s = states[dist.get_rank(group)]
    tot = shard_sum(far.gather_shards(_epoch_traffic(cfg.shard, s), group))
    plane_lib.advance_epoch(cfg.shard, s, traffic=(tot[0], tot[1]))
    return states


def _mesh_evacuate(cfg: ShardedPlaneConfig, group, garbage_threshold,
                   max_pages, clear_access, states):
    me = dist.get_rank(group)
    plane_lib.evacuate(cfg.shard, states[me],
                       garbage_threshold=garbage_threshold,
                       max_pages=max_pages, clear_access=clear_access,
                       shard=me)
    return states


# --------------------------------------------------------------------------
# entry points (JAX's memoized jit entries; group=None -> the loop oracle)
# --------------------------------------------------------------------------

def jitted_access(cfg: ShardedPlaneConfig, mode=None, group=None, *,
                  with_served: bool = False, degraded: bool = False,
                  reclaim=None):
    """``(states, ids [S, R]) -> (states, rows)``, plus ``served`` with
    ``with_served``; ``degraded=True`` is the hits-only breaker variant.
    ``group=None`` runs the loop oracle (rows ``[S, R, D]``); a far group
    runs this rank's shard (rows ``[R, D]``, its block)."""
    mode = mode or cfg.shard.access_mode
    if group is None:
        return partial(access, cfg, mode=mode, degraded=degraded,
                       with_served=with_served, reclaim=reclaim)
    return partial(_mesh_access, cfg, group, mode, with_served, reclaim,
                   degraded=degraded)


def jitted_access_degmask(cfg: ShardedPlaneConfig, mode=None, group=None, *,
                          with_served: bool = True, reclaim=None):
    """``(states, ids [S, R], deg [S] bool) -> (states, rows, served?)``:
    the per-shard breaker's entry.  Shards with ``deg[k]`` serve local
    hits only; an all-False mask gives the plain program's results bit for
    bit."""
    mode = mode or cfg.shard.access_mode
    if group is None:
        def oracle(states, ids, deg):
            return access(cfg, states, ids, mode=mode, degraded=deg,
                          with_served=with_served, reclaim=reclaim)
        return oracle
    return partial(_mesh_access, cfg, group, mode, with_served, reclaim)


def jitted_update(cfg: ShardedPlaneConfig, mode=None, group=None):
    """``(states, ids [S, R], rows [S, R, D]) -> states``."""
    mode = mode or cfg.shard.access_mode
    if group is None:
        return partial(update, cfg, mode=mode)
    return partial(_mesh_update, cfg, group, mode)


def jitted_advance_epoch(cfg: ShardedPlaneConfig, group=None):
    """``states -> states``, every shard on the global traffic."""
    if group is None:
        return partial(advance_epoch, cfg)
    return partial(_mesh_epoch, cfg, group)


def jitted_evacuate(cfg: ShardedPlaneConfig, garbage_threshold=None,
                    max_pages: int = 16, clear_access: bool = True,
                    group=None):
    """``states -> states``, each shard compacted on its own."""
    if group is None:
        return partial(evacuate, cfg, garbage_threshold=garbage_threshold,
                       max_pages=max_pages, clear_access=clear_access)
    return partial(_mesh_evacuate, cfg, group, garbage_threshold, max_pages,
                   clear_access)


def _probe(cfg: ShardedPlaneConfig, phase: str, ids, *, pack, a2a):
    """The truncated exchange: every round's pack, and with ``"ingress"``
    the fused ingress payload's collective too; per shard the int32 sum of
    every payload and spill count (leading dims from ``ids``)."""
    todo = ids >= 0
    acc = torch.zeros(ids.shape[:-1], dtype=I32, device=ids.device)
    for _ in range(cfg.rounds):
        send, cnt, todo, nsp = pack(ids, todo)
        x = kops.fuse_ids_counts(send, cnt)
        if phase == "ingress":
            x = a2a(x)
        acc = acc + x.reshape(acc.shape + (-1,)).sum(dim=-1, dtype=I32) + nsp
    return acc


def phase_probe(cfg: ShardedPlaneConfig, phase: str, group=None):
    """``ids [S, R] -> checksums``: the benchmark-only probe of JAX's
    ``jitted_phase_probe``, which times ``"pack"``, then ``"ingress"``
    (pack + the fused collective), against a full access to split a call
    into pack, collective and serve.  ``group=None`` runs the loop oracle
    over the S shards (``[S]``); a far group this rank's shard (``[1]``,
    its block)."""
    if phase not in ("pack", "ingress"):
        raise ValueError(f"phase {phase!r}: 'pack' or 'ingress'")
    if group is None:
        return partial(_probe, cfg, phase,
                       pack=_stacked(partial(_pack_round, cfg), cfg.shards),
                       a2a=_swap)

    def probe(ids):
        me = dist.get_rank(group)
        return _probe(cfg, phase, ids.to(far.far_device(group))[me],
                      pack=partial(_pack_round, cfg),
                      a2a=partial(far.all_to_all, group))[None]
    return probe


# --------------------------------------------------------------------------
# introspection (with a group, gathered from every rank)
# --------------------------------------------------------------------------

def stack_shards(states, fn, group=None) -> torch.Tensor:
    """``[S, ...]``: ``fn`` of each shard's state, in shard order
    (gathered from every rank under a group)."""
    if group is None:
        return torch.stack([fn(s) for s in states])
    return far.gather_shards(fn(states[dist.get_rank(group)]), group)


def stats_total(states, group=None) -> st.PlaneStats:
    """Global counters: each stat summed over the shards."""
    per = stack_shards(states, lambda s: torch.stack(
        list(s.stats._asdict().values())), group)
    return st.PlaneStats(*per.sum(dim=0, dtype=I32).unbind())


def paging_fraction(cfg: ShardedPlaneConfig, states, group=None
                    ) -> torch.Tensor:
    """Fraction of allocated pages (across ALL shards) on the paging
    path."""
    V = cfg.shard.num_vpages

    def counts(s):
        allocated = s.backing[:V] != FREE
        return torch.stack([(s.psf[:V] & allocated).sum(dtype=I32),
                            allocated.sum(dtype=I32)])
    pg, alloc = stack_shards(states, counts, group).sum(dim=0, dtype=I32)
    return pg / alloc.clamp_min(1)


def check_invariants(cfg: ShardedPlaneConfig, states) -> dict:
    """Per-shard structural invariants, AND-merged over the shards this
    process holds (host booleans)."""
    out: dict = {}
    for s in states:
        if s is None:
            continue
        for k, v in plane_lib.check_invariants(cfg.shard, s).items():
            out[k] = out.get(k, True) and v
    return out
