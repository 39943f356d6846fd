"""Serving engine: continuous batching over a data plane (PyTorch port of
``repro.serving.engine``).

The engine serves key-value GET requests against a far-memory-resident
object store managed by one of the three data planes: ``hybrid``,
``paging`` (the Fastswap analogue) or ``object`` (the AIFM analogue, with
its object-level LRU reclaim after every batch).  Each batch is submitted
as two calls on the device's stream, a plan and an execute.
``dispatch="pipelined"`` (default) keeps up to ``pipeline_depth`` batches
in flight and blocks only on the oldest one; ``dispatch="sync"`` retires
every batch at once.  Both produce the same rows and plane state.  JAX's
``is_ready()`` becomes a CUDA event recorded after each call and polled
with ``Event.query()`` (on the CPU every call has finished when it
returns).  The hybrid and paging planes never sync with the host inside a
batch; the object plane's reclaim loop reads its condition on the host
(``core.baselines``).

Background evacuation (``evac_budget``) and the epoch governor
(``epoch_every``, ``epoch_watermark_bytes``) run between batches on the
hybrid plane, as in the JAX engine.

Robust serving, as in JAX: with a ``faults.Schedule`` (riding in the
``PlaneConfig``), ``deadline_us``, ``max_retries`` or
``breaker_threshold`` set, each plan's per-request ``served`` verdicts come
back to the host with the batch's rows (an asynchronous copy to pinned
memory recorded before the batch's event), unserved requests re-enter
later batches' tail slots up to ``max_retries`` times or are shed, late
arrivals are shed at admission, and a circuit breaker over an
asynchronous health probe (another copy behind an event) serves local
hits only while the far tier fails.  Pipelined dispatch acts on the
breaker a tick late, as in JAX.

The sharded far tier (``shards > 1``, ``core.shardplane``): the batch
splits evenly over the source shards (``batch // shards`` requests each)
and goes through ONE fused access a tick, in both dispatch modes (the
exchange interleaves plan and execute per round).  Evacuation slices and
the epoch run per shard through ``shardplane``; robust engines take the
served channel back with the rows, and the circuit breaker keeps one
health column a shard: ``breaker_scope="shard"`` trips and closes each
shard on its own window, ``"global"`` all of them on the summed one, and
either drives ``jitted_access_degmask`` with the ``[S]`` mask as data (an
all-False mask gives the plain program's results bit for bit).  With a
process group (``launch.mesh``, JAX's ``mesh=``) each rank holds its own
shard and runs the same exchange over ``torch.distributed``: every rank
is given the same global batch, serves its own row block, and ``submit``
returns the whole batch's rows on every rank (an all_gather of the
blocks, as JAX's host reads the global array whole); the per-shard health
counters and the run's stats are gathered the same way when read.

With a profiler recording, each tick's parts run under named spans
(``core.trace``: ``engine.submit`` over ``engine.admit``, ``engine.plan``,
``engine.execute``, ``engine.evacuate``, ``engine.epoch`` and
``engine.retire`` with its ``engine.wait``), each carrying its tick.

On a card, an engine over one plane state (the hybrid or paging plane,
the batch executor, no robust serving) replays its three device calls
from captured CUDA graphs (``replays``): the batch's plan and execute,
the evacuation round (or its slices) and the epoch, one graph launch
each in place of hundreds of eager launches.  Each runs eagerly the
first time it comes due, is captured the next time and replayed from
then on (``_Replay``); the rows are copied out of the graph's output.
Every other engine, and every engine on the CPU, dispatches eagerly.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..core import baselines
from ..core import batch as batch_lib
from ..core import plane as plane_lib
from ..core import shardplane
from ..core import state as state_lib
from ..core import trace
from ..core.layout import PlaneConfig
from ..kernels import ops
from ..launch import mesh as mesh_lib


@dataclasses.dataclass
class EngineConfig:
    """Same fields and defaults as the JAX ``EngineConfig``."""
    plane: str = "hybrid"           # hybrid | paging | object
    batch: int = 64                 # requests per engine tick
    evac_every: int = 64            # hybrid-plane evacuation period (ticks)
    # kept for the JAX field set; unused there and here: the object plane
    # always reclaims to execute_object_access's default of 2 free frames
    reclaim_free_target: int = 2
    mode: str = "batch"             # plan-then-execute engine | "reference" oracle
    dispatch: str = "pipelined"     # "pipelined" double-buffer | "sync"
    pipeline_depth: int = 2         # max in-flight batches before blocking
    # 0 = one foreground max_pages=16 compaction every evac_every ticks;
    # >0 = the round's 16 pages as evac_budget-page slices spread across it
    evac_budget: int = 0
    epoch_every: int = 0            # advance_epoch every this many ticks
    epoch_watermark_bytes: int = 0  # ... or once this many bytes moved
    shards: int = 1
    shard_budget: int = 0
    shard_exchange: str = "overlap"
    faults: object = None
    deadline_us: float = 0.0
    max_retries: int = 0
    shed_policy: str = "deadline"
    retry_queue_cap: int = 1024
    watchdog_s: float = 120.0       # a batch still not done after this raises
    breaker_threshold: float = 0.0
    breaker_probe_every: int = 4
    breaker_hysteresis: float = 0.5
    breaker_scope: str = "shard"


class LatencyTracker:
    """Latency sink with bounded memory: exact count and mean plus a
    fixed-capacity uniform reservoir (Vitter's algorithm R, vectorized,
    deterministically seeded) for the percentiles."""

    def __init__(self, capacity: int = 65536, seed: int = 0x5EED):
        self.capacity = int(capacity)
        self._buf = np.empty((self.capacity,), np.float64)
        self._rng = np.random.RandomState(seed)
        self.n = 0
        self._sum = 0.0

    def record(self, t_in: float, t_out: float, n: int):
        if n > 0:
            self.record_us(np.full((int(n),), (t_out - t_in) * 1e6))

    def record_us(self, lat_us):
        """Record a vector of per-request latencies (microseconds)."""
        lat = np.asarray(lat_us, np.float64).reshape(-1)
        if lat.size == 0:
            return
        self._sum += float(lat.sum())
        pos = self.n + np.arange(lat.size)
        head = pos < self.capacity
        if head.any():
            self._buf[pos[head]] = lat[head]
        tail = ~head
        if tail.any():
            # stream element j replaces a random slot with p = capacity/(j+1)
            j = pos[tail]
            r = np.floor(self._rng.random_sample(j.size) * (j + 1)
                         ).astype(np.int64)
            hit = r < self.capacity
            self._buf[r[hit]] = lat[tail][hit]
        self.n += int(lat.size)

    def percentile(self, p: float) -> float:
        k = min(self.n, self.capacity)
        return float(np.percentile(self._buf[:k], p)) if k else 0.0

    def summary(self) -> dict:
        if self.n == 0:
            return {}
        a = self._buf[:min(self.n, self.capacity)]
        return {"p50_us": float(np.percentile(a, 50)),
                "p90_us": float(np.percentile(a, 90)),
                "p99_us": float(np.percentile(a, 99)),
                "mean_us": self._sum / self.n, "n": self.n}


class _Done:
    """Completion marker of work queued so far on a device: a CUDA event
    recorded on the current stream, or nothing on the CPU (eager CPU work
    is finished when the call returns)."""

    def __init__(self, device: torch.device):
        self._ev = None
        if device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record(torch.cuda.current_stream(device))

    def ready(self) -> bool:
        return self._ev is None or self._ev.query()

    def wait(self) -> None:
        if self._ev is not None:
            self._ev.synchronize()


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of ``x`` into pinned host memory (valid once a
    ``_Done`` recorded after this call is reached); a copy on the CPU."""
    if x.device.type == "cuda":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return h
    return x.clone()


class _Inflight(NamedTuple):
    """One dispatched batch awaiting retirement."""
    rows: torch.Tensor      # [batch, D] on the device
    done: _Done
    t_sched: float          # batch scheduled-arrival clock
    n: int                  # caller's request count (first n slots)
    served: object = None   # host [batch] bool (robust engines only)
    ids: object = None      # np [batch] int32 slot ids (incl. retries, -1 pad)
    t0s: object = None      # np [batch] float64 per-slot arrival clocks
    att: object = None      # np [batch] int32 per-slot attempt counts
    tick: int = 0           # the engine tick that dispatched it


_EMPTY_IDS = np.empty((0,), np.int32)

_STATE_FIELDS = tuple(k for k in state_lib.PlaneState._fields
                      if k != "stats")
_STATS_FIELDS = state_lib.PlaneStats._fields


def robust(cfg: EngineConfig) -> bool:
    """Whether an engine serves robustly: a fault schedule, a deadline,
    retries or a circuit breaker."""
    return (cfg.faults is not None or cfg.deadline_us > 0
            or cfg.max_retries > 0 or cfg.breaker_threshold > 0)


def replays(cfg: EngineConfig, pcfg: PlaneConfig, device, group=None
            ) -> bool:
    """Whether an engine replays its device calls from captured CUDA
    graphs: on a card, over one plane state with no process group, on the
    hybrid or paging plane, with the batch executor and without robust
    serving.  The object plane's reclaim reads the host, robust serving
    acts on the host inside a tick, sharded engines exchange between
    shards, and the reference executor is the oracle: those, and every
    engine on the CPU, dispatch eagerly."""
    return (torch.device(device).type == "cuda" and cfg.shards == 1
            and group is None and cfg.plane in ("hybrid", "paging")
            and cfg.mode == "batch" and not robust(cfg)
            and pcfg.faults is None)


def _tensors(s) -> list:
    """The tensors of plane state ``s``: its fields, then its counters."""
    return ([getattr(s, k) for k in _STATE_FIELDS]
            + [getattr(s.stats, k) for k in _STATS_FIELDS])


def _bind(s, stats, tensors: list) -> None:
    """Bind ``tensors`` (in ``_tensors``' order) to ``s``'s fields and to
    the counters ``stats``, which ``s`` then holds."""
    s.stats = stats
    n = len(_STATE_FIELDS)
    for k, t in zip(_STATE_FIELDS, tensors[:n]):
        setattr(s, k, t)
    for k, t in zip(_STATS_FIELDS, tensors[n:]):
        setattr(stats, k, t)


def _rebound(s, held: list) -> list:
    """``(held tensor, bound tensor)`` for each field of ``s`` rebound since
    ``held`` (its ``_tensors``) was taken.  Raises ``ValueError`` where one
    differs from its held tensor in shape, dtype or device."""
    moved = [(h, t) for h, t in zip(held, _tensors(s)) if h is not t]
    for h, t in moved:
        if (t.shape, t.dtype, t.device) != (h.shape, h.dtype, h.device):
            raise ValueError(f"a field of shape {tuple(h.shape)} {h.dtype} "
                             f"was rebound to {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    return moved


def _copy(pairs: list) -> None:
    """``dst.copy_(src)`` for each ``(dst, src)``: one foreach copy a
    dtype."""
    by_dtype = {}
    for d, t in pairs:
        a, b = by_dtype.setdefault(d.dtype, ([], []))
        a.append(d)
        b.append(t)
    for a, b in by_dtype.values():
        torch._foreach_copy_(a, b)


def in_place(fn, s, *args):
    """``fn(s, *args)`` with every field of ``s`` that it rebinds, rather
    than writes in place (a 0-d field, a counter), written back into the
    tensor it held before and bound to it again, so that ``s`` keeps its
    tensors: a graph captured over the call reads and writes the same
    tensors on every replay.  Raises ``ValueError``, with the old tensors
    bound back, where a field was rebound to a tensor of another shape,
    dtype or device, or to storage that another field holds: the write-back
    would then change what the call means."""
    stats, held = s.stats, _tensors(s)
    try:
        out = fn(s, *args)
        moved = _rebound(s, held)
        ptrs = [t.untyped_storage().data_ptr()
                for t in held + [t for _, t in moved]]
        if len(set(ptrs)) < len(ptrs):
            raise ValueError("a field was rebound to storage that another "
                             "field holds")
        _copy(moved)
    finally:
        _bind(s, stats, held)
    return out


def adopt(s, held: list) -> None:
    """Bind ``s``'s fields back to ``held`` (its tensors when a graph was
    captured), copying in the value of each field rebound since (by a
    caller outside the engine, or an eager call).  Raises ``ValueError``,
    binding nothing, where a rebound field's shape, dtype or device differ
    from its held tensor's."""
    moved = _rebound(s, held)
    if moved:
        _copy(moved)
        _bind(s, s.stats, held)


class _Replay:
    """One of the engine's device calls, ``fn(state, *inputs)``, replayed
    from a captured CUDA graph.

    The first call runs eagerly; the next is captured (``in_place`` over
    the call, with a private memory pool) and, since capture runs nothing
    on the card, replayed at once; every later call replays.  A replay
    reads the state's tensors and the ``inputs`` as captured (the caller
    fills them in place) and returns the graph's own output, which the
    next replay overwrites.  A field rebound between calls is adopted
    (``adopt``); a state replaced whole is captured anew.  A capture that
    raises leaves the call eager for the engine's life, counted under
    ``failed``.  ``counts`` (the engine's ``replay_counts``) tallies
    captures, replays and eager calls.  The kernel launch counts
    (``ops.launch_counts``) take each replay's launches, those the
    captured call counted, and nothing for the capture."""

    def __init__(self, fn, span: str, counts: dict):
        self.fn, self.span, self.counts = fn, span, counts
        self.graph = self.state = self.held = self.out = None
        self.launches = {}          # kernel launches of one replay
        self.ran = False            # the eager first call was made
        self.eager = False          # a capture failed: eager for good

    def __call__(self, s, *inputs):
        if self.graph is not None:
            if s is self.state:
                adopt(s, self.held)
            else:
                self.graph = None   # a state replaced whole: capture anew
        if self.graph is None and (self.eager or not self.ran
                                   or not self._capture(s, inputs)):
            self.ran = True
            self.counts["eager"] += 1
            return self.fn(s, *inputs)
        with trace.span(self.span):
            self.graph.replay()
        ops.add_launches(self.launches)
        self.counts["replays"] += 1
        return self.out

    def _capture(self, s, inputs) -> bool:
        """Capture the call on ``s`` on a side stream; False where the
        capture raised (nothing ran and ``s`` holds its tensors)."""
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        try:
            with torch.cuda.device(s.device), torch.cuda.stream(
                    torch.cuda.Stream(s.device)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = in_place(self.fn, s, *inputs)
                finally:
                    graph.capture_end()
        except (RuntimeError, ValueError):
            self.eager = True
            self.counts["failed"] += 1
            return False
        finally:
            # the wrappers counted the captured launches, which ran nothing
            launched = {k: n - before[k]
                        for k, n in ops.launch_counts().items()
                        if n != before[k]}
            ops.add_launches({k: -n for k, n in launched.items()})
        self.graph, self.state, self.out = graph, s, out
        self.held = _tensors(s)
        self.launches = launched
        self.counts["captures"] += 1
        return True


class Engine:
    """Continuous-batching serving engine (one device, or one rank of a
    far group).

    ``submit`` enqueues one batch (plan + execute) and returns its rows (a
    device tensor, complete once the batch retires); ``drain`` blocks on
    everything still in flight; ``serve_batch`` is submit + drain."""

    def __init__(self, cfg: EngineConfig, pcfg: PlaneConfig, initial,
                 device="cuda", group=None):
        if cfg.plane not in ("hybrid", "paging", "object"):
            raise ValueError(cfg.plane)
        if cfg.faults is not None:
            # the schedule rides in the plane config, as in JAX
            pcfg = dataclasses.replace(pcfg, faults=cfg.faults)
        self.cfg = cfg
        self.pcfg = pcfg
        self.scfg = None
        self.group = group
        self._robust = robust(cfg)
        self._breaker_on = self._robust and cfg.breaker_threshold > 0
        self.reclaim = None
        self.ticks = 0
        self.replay_counts = dict.fromkeys(
            ("captures", "replays", "eager", "failed"), 0)
        self._access_replay = None
        self._epoch_on = cfg.plane == "hybrid" and (
            cfg.epoch_every > 0 or cfg.epoch_watermark_bytes > 0)
        if cfg.shards > 1:
            self._init_sharded(initial, device)
        else:
            self.device = state_lib.resolve_device(device)
            self.state = state_lib.create(pcfg, initial, device=self.device)
            self._init_plain()
        if cfg.plane == "hybrid" and cfg.evac_budget > 0:
            slices = -(-16 // cfg.evac_budget)          # ceil(16/budget)
            self._evac_slice_period = max(1, cfg.evac_every // slices)
            self._evac_round = 0        # last round whose access-clear ran
        self._probe = None              # in-flight traffic watermark read
        self._hprobe = None             # in-flight health probe read
        self._hlast = np.zeros((2, cfg.shards), np.float64)
        self.shard_fail_frac = np.zeros((cfg.shards,), np.float64)
        self.breaker_open_shards = np.zeros((cfg.shards,), bool)
        self.served_per_shard = np.zeros((cfg.shards,), np.int64)
        self._retryq: deque = deque()   # (obj_id, t0, attempt)
        self.counters = {"served": 0, "fetch_retries": 0, "shed_requests": 0,
                         "deadline_misses": 0, "degraded_ticks": 0,
                         "breaker_trips": 0}
        self.latency = LatencyTracker()
        self._inflight: deque[_Inflight] = deque()      # oldest-first
        # the counters start at zero after the warm-up, as in JAX
        for s in self._shards():
            s.stats = state_lib.PlaneStats.zeros(self.device)
            s.epoch_page_ins = torch.zeros_like(s.epoch_page_ins)
            s.epoch_obj_ins = torch.zeros_like(s.epoch_obj_ins)

    def _init_sharded(self, initial, device):
        """The sharded far tier: per-shard states (this rank's alone under
        a group) and the shardplane entry points.  The warm-up runs one
        all-zeros access and, on the hybrid plane, one evacuation, as the
        JAX engine does; the entries whose warm-up result JAX discards (the
        degraded-mask access, the evacuation slices, the epoch) change the
        state here and are not warmed."""
        cfg, pcfg = self.cfg, self.pcfg
        if cfg.batch % cfg.shards:
            raise ValueError(f"batch={cfg.batch} must split evenly over "
                             f"{cfg.shards} shards")
        S = cfg.shards
        self.scfg = scfg = shardplane.make_config(
            pcfg, S, cfg.batch // S, cfg.shard_budget or None,
            plane=cfg.plane, exchange=cfg.shard_exchange)
        g = self.group
        self.device = (state_lib.resolve_device(device) if g is None
                       else mesh_lib.far_device(g))
        self.state = shardplane.create(scfg, initial, device=self.device)
        if g is not None:
            self.state = mesh_lib.put_far(self.state, g)
        if cfg.plane == "object":
            # one reclaim loop per shard state (each keeps its own bound)
            self.reclaim = [baselines.ObjectReclaim() for _ in range(S)]
        self._access = shardplane.jitted_access(
            scfg, cfg.mode, g, with_served=self._robust,
            reclaim=self.reclaim)
        self._access_degmask = None
        if self._breaker_on:
            self._access_degmask = shardplane.jitted_access_degmask(
                scfg, cfg.mode, g, with_served=True, reclaim=self.reclaim)
        if cfg.plane == "hybrid":
            self._evac = shardplane.jitted_evacuate(scfg, group=g)
            self._evac_slice, self._evac_slice_clear = (
                shardplane.jitted_evacuate(
                    scfg, max_pages=cfg.evac_budget, clear_access=c,
                    group=g) for c in (False, True))
            self._epoch = shardplane.jitted_advance_epoch(scfg, g)
        warm = torch.zeros((S, cfg.batch // S), dtype=torch.int32,
                           device=self.device)
        self._access(self.state, warm)
        if cfg.plane == "hybrid":
            self._evac(self.state)

    def _init_plain(self):
        cfg, pcfg = self.cfg, self.pcfg
        if cfg.plane == "hybrid":
            self._plan_kw, self._exec = {}, batch_lib.execute_access
            self._evac = functools.partial(plane_lib.evacuate, pcfg)
            self._evac_slice, self._evac_slice_clear = (
                functools.partial(plane_lib.evacuate, pcfg,
                                  max_pages=cfg.evac_budget, clear_access=c)
                for c in (False, True))
            self._epoch = functools.partial(plane_lib.advance_epoch, pcfg)
        elif cfg.plane == "paging":
            self._plan_kw = dict(split_by_psf=False)
            self._exec = batch_lib.execute_paging_access
        else:
            # one reclaim loop per plane state (it keeps a bound on the
            # free frames between batches)
            self.reclaim = baselines.ObjectReclaim()
            self._plan_kw = dict(all_runtime=True)
            self._exec = functools.partial(
                batch_lib.execute_object_access, reclaim=self.reclaim)
        # the JAX engine warms its compiled paths with one all-zeros batch
        # and, on the hybrid plane, one foreground evacuation; both change
        # the state, so the port runs them too (and the first call builds
        # the kernels).  The degraded plan is warmed and discarded, as in
        # JAX: a plan reads the state and never writes it.
        warm = torch.zeros((cfg.batch,), dtype=torch.int32,
                           device=self.device)
        self._exec(pcfg, self.state, warm, self._plan(warm), mode=cfg.mode)
        if cfg.plane == "hybrid":
            self._evac(self.state)
        if self._breaker_on:
            self._plan(warm, degraded=True)
        if replays(cfg, pcfg, self.device, self.group):
            n = self.replay_counts
            self._ids_in = torch.empty((cfg.batch,), dtype=torch.int32,
                                       device=self.device)
            self._access_replay = _Replay(self._plan_exec,
                                          "engine.execute.replay", n)
            if cfg.plane == "hybrid":
                self._evac, self._evac_slice, self._evac_slice_clear = (
                    _Replay(f, "engine.evacuate.replay", n) for f in (
                        self._evac, self._evac_slice,
                        self._evac_slice_clear))
                self._epoch = _Replay(self._epoch, "engine.epoch.replay", n)

    def _shards(self) -> list:
        """The plane states this process holds."""
        if self.scfg is None:
            return [self.state]
        return [s for s in self.state if s is not None]

    def _plan(self, ids: torch.Tensor, degraded: bool = False):
        with trace.span("engine.plan", self.ticks + 1):
            return batch_lib.plan_access(self.pcfg, self.state, ids,
                                         degraded=degraded, **self._plan_kw)

    @property
    def breaker_open(self) -> bool:
        """True if ANY shard's breaker is open."""
        return bool(self.breaker_open_shards.any())

    def _sharded_access(self, ids: torch.Tensor, dmask=None):
        """One fused sharded access of the padded ``[batch]`` ids; returns
        ``(rows [batch, D], served [batch] or None)``, whole on every rank
        under a group."""
        cfg = self.cfg
        with trace.span("engine.execute", self.ticks + 1):
            ids = ids.reshape(cfg.shards, cfg.batch // cfg.shards)
            if dmask is not None and self._access_degmask is not None:
                out = self._access_degmask(self.state, ids, torch.from_numpy(
                    dmask).to(self.device))
            else:
                out = self._access(self.state, ids)
            rows, sv = out[1], (out[2] if self._robust else None)
            if self.group is not None:
                rows = mesh_lib.gather_shards(rows, self.group)
                if sv is not None:
                    sv = mesh_lib.gather_shards(sv, self.group)
            return (rows.reshape(cfg.batch, -1),
                    None if sv is None else sv.reshape(cfg.batch))

    # -- pipelined dispatch -------------------------------------------------

    def submit(self, obj_ids, t_sched: float | None = None) -> torch.Tensor:
        """Enqueue one batch; returns its rows.  Blocks only when more than
        ``pipeline_depth`` batches are in flight, never on this batch."""
        t_sched = time.time() if t_sched is None else t_sched
        with trace.span("engine.submit", self.ticks + 1):
            # opportunistic retirement of anything already finished
            while self._inflight and self._inflight[0].done.ready():
                self._retire_one()
            if self._robust:
                rows = self._submit_robust(obj_ids, t_sched)
            else:
                rows = self._dispatch(obj_ids, t_sched)
            self.ticks += 1
            self._maintenance()
            limit = (0 if self.cfg.dispatch == "sync"
                     else self.cfg.pipeline_depth)
            while len(self._inflight) > limit:
                self._retire_one()
            return rows

    def _ids(self, obj_ids) -> torch.Tensor:
        """The batch's ids as an int32 [batch] device tensor, short batches
        padded with the plane's negative-id no-ops (fixed shapes)."""
        B = self.cfg.batch
        with trace.span("engine.admit", self.ticks + 1):
            if isinstance(obj_ids, torch.Tensor):
                ids = obj_ids.to(self.device, torch.int32).reshape(-1)
            else:
                host = torch.from_numpy(np.ascontiguousarray(obj_ids,
                                                             np.int32))
                if self.device.type == "cuda":
                    host = host.pin_memory()
                ids = host.to(self.device, non_blocking=True).reshape(-1)
            n = ids.shape[0]
            if n > B:
                raise ValueError(f"batch of {n} > configured batch={B}")
            if n < B:
                ids = torch.cat([ids, torch.full(
                    (B - n,), -1, dtype=torch.int32, device=self.device)])
            return ids

    def _dispatch(self, obj_ids, t_sched):
        ids = self._ids(obj_ids)
        n = len(obj_ids)
        if self.scfg is not None:
            rows_full, _ = self._sharded_access(ids)
        elif self._access_replay is not None:
            # the graph reads its ids from one buffer and writes its rows to
            # one output, which the next replay overwrites: copy them out
            self._ids_in.copy_(ids)
            with trace.span("engine.execute", self.ticks + 1):
                rows_full = self._access_replay(self.state,
                                                self._ids_in).clone()
        else:
            plan = self._plan(ids)
            with trace.span("engine.execute", self.ticks + 1):
                _, rows_full = self._exec(self.pcfg, self.state, ids, plan,
                                          mode=self.cfg.mode)
        self._inflight.append(_Inflight(rows_full, _Done(self.device),
                                        t_sched, n, tick=self.ticks + 1))
        return rows_full[:n] if n < self.cfg.batch else rows_full

    def _plan_exec(self, s, ids: torch.Tensor) -> torch.Tensor:
        """The batch's plan and execute on ``s``: its rows (the call the
        engine's access graph captures)."""
        plan = batch_lib.plan_access(self.pcfg, s, ids, **self._plan_kw)
        return self._exec(self.pcfg, s, ids, plan, mode=self.cfg.mode)[1]

    def _submit_robust(self, obj_ids, t_sched):
        """Chaos-mode dispatch: deadline shed at admission, retry slots in
        the batch tail, per-slot served verdicts, circuit-breaker routing.
        ``obj_ids`` is read on the host (a device tensor is copied back)."""
        cfg = self.cfg
        tick = self.ticks + 1
        with trace.span("engine.admit", tick):
            if isinstance(obj_ids, torch.Tensor):
                obj_ids = obj_ids.cpu().numpy()
            ids_np = np.asarray(obj_ids, np.int32).reshape(-1)
            n = ids_np.size
            if n > cfg.batch:
                raise ValueError(
                    f"batch of {n} > configured batch={cfg.batch}")
            now = time.time()
            shedding = cfg.deadline_us > 0 and cfg.shed_policy == "deadline"
            shed = (shedding and n > 0
                    and (now - t_sched) * 1e6 > cfg.deadline_us)
            if shed:
                # the whole arrival is already past its SLO: count it out
                self.counters["shed_requests"] += n
                self.counters["deadline_misses"] += n
            full = np.full((cfg.batch,), -1, np.int32)
            t0s = np.full((cfg.batch,), now, np.float64)
            att = np.zeros((cfg.batch,), np.int32)
            k = 0
            if n and not shed:
                # new requests first: rows[:n] stay aligned with the
                # caller's ids
                full[:n] = ids_np
                t0s[:n] = t_sched
                k = n
            while self._retryq and k < cfg.batch:
                rid, rt0, ratt = self._retryq.popleft()
                if shedding and (now - rt0) * 1e6 > cfg.deadline_us:
                    self.counters["shed_requests"] += 1
                    self.counters["deadline_misses"] += 1
                    continue
                full[k] = rid
                t0s[k] = rt0
                att[k] = ratt
                k += 1
        sched = cfg.faults
        if sched is not None:
            # a deterministic dispatch stall, then slow-but-alive windows:
            # pure latency, never fed to the failure counters
            d_us = sched.spike(tick)
            if d_us > 0.0:
                time.sleep(d_us * 1e-6)
            slow = sched.slow_us(tick)
            if slow > 0.0:
                time.sleep(slow * 1e-6)
        # per-shard degraded mask: tripped shards serve local hits only,
        # except on probe ticks; healthy shards always run the full path
        dmask = np.zeros((cfg.shards,), bool)
        if (self._breaker_on and self.breaker_open
                and tick % cfg.breaker_probe_every != 0):
            dmask = self.breaker_open_shards.copy()
            self.counters["degraded_ticks"] += int(dmask.sum())
        ids = self._ids(full)
        if self.scfg is not None:
            rows_full, served = self._sharded_access(ids, dmask)
        else:
            plan = self._plan(ids, degraded=bool(dmask[0]))
            with trace.span("engine.execute", tick):
                _, rows_full = self._exec(self.pcfg, self.state, ids, plan,
                                          mode=cfg.mode)
            served = plan.served
        served = _to_host(served)
        self._inflight.append(_Inflight(rows_full, _Done(self.device),
                                        t_sched, n, served, full, t0s, att,
                                        tick))
        if self._breaker_on:
            self._breaker_step()
        if shed:
            return torch.zeros((n, rows_full.shape[1]), dtype=rows_full.dtype,
                               device=self.device)
        return rows_full[:n] if n < cfg.batch else rows_full

    def _maintenance(self):
        """Per-tick background work on the hybrid plane (evacuation
        slices, epoch governor), one shard after another when sharded."""
        cfg, s = self.cfg, self.state
        if cfg.plane != "hybrid":
            return
        if cfg.evac_budget > 0:
            if self.ticks % self._evac_slice_period == 0:
                # access bits clear once per evac_every round, on the first
                # slice of each new round
                round_id = self.ticks // cfg.evac_every
                clear = round_id > self._evac_round
                if clear:
                    self._evac_round = round_id
                with trace.span("engine.evacuate", self.ticks):
                    (self._evac_slice_clear if clear
                     else self._evac_slice)(s)
        elif self.ticks % cfg.evac_every == 0:
            with trace.span("engine.evacuate", self.ticks):
                self._evac(s)
        if self._epoch_on and self._epoch_due():
            with trace.span("engine.epoch", self.ticks):
                self._epoch(s)
            self._probe = None          # watermark restarts from the epoch

    def _per_shard(self, fn) -> torch.Tensor:
        """``[S, ...]``: ``fn`` of each shard's state in shard order
        (gathered from every rank under a group)."""
        if self.scfg is None:
            return fn(self.state)[None]
        return shardplane.stack_shards(self.state, fn, self.group)

    def _traffic(self) -> torch.Tensor:
        """Bytes moved (paging + object ingress) since the last epoch,
        summed over the shards in shard order."""
        pb, rb = float(self.pcfg.page_bytes), float(self.pcfg.row_bytes)
        return shardplane.shard_sum(self._per_shard(lambda s: (
            (s.stats.page_ins - s.epoch_page_ins).to(torch.float32) * pb
            + (s.stats.obj_ins - s.epoch_obj_ins).to(torch.float32) * rb)))

    def _epoch_due(self) -> bool:
        """The tick period is the fallback; the byte watermark fires once an
        async traffic probe reads past ``epoch_watermark_bytes`` (pipelined
        dispatch polls the probe and acts a tick late, never blocking)."""
        cfg = self.cfg
        if cfg.epoch_every > 0 and self.ticks % cfg.epoch_every == 0:
            return True
        if cfg.epoch_watermark_bytes <= 0:
            return False
        if self._probe is None:
            self._probe = (self._traffic(), _Done(self.device))
            if cfg.dispatch != "sync":
                return False            # poll on a later tick
        value, done = self._probe
        if cfg.dispatch == "sync" or done.ready():
            self._probe = None
            return float(value) >= cfg.epoch_watermark_bytes
        return False

    def _health(self):
        """Cumulative (failed, attempted) remote fetches per shard, ``[2,
        S]`` f32, copied to the host behind an event.  Attempts are
        successful ingress plus failures, so a window's fraction measures
        its probe ticks' health."""
        h = self._per_shard(lambda s: torch.stack([
            s.stats.fetch_failures,
            s.stats.page_ins + s.stats.obj_ins + s.stats.fetch_failures]))
        return _to_host(h.to(torch.float32).T.contiguous()), _Done(
            self.device)

    def _breaker_step(self):
        """Async circuit-breaker update, the same non-blocking shape as
        ``_epoch_due``: start a cumulative (failures, attempts) probe, poll
        it on later ticks, and act on the delta since the previous reading.
        ``breaker_scope="shard"`` trips and closes each shard column on its
        own windowed fraction (only with evidence, attempts > 0), at
        ``breaker_threshold`` and at threshold * hysteresis; ``"global"``
        decides on the summed fractions.  With one shard both act alike."""
        cfg = self.cfg
        if self._hprobe is None:
            self._hprobe = self._health()
            if cfg.dispatch != "sync":
                return                  # poll on a later tick
        value, done = self._hprobe
        if cfg.dispatch != "sync" and not done.ready():
            return
        done.wait()
        cur = value.numpy().astype(np.float64).reshape(2, -1)
        self._hprobe = None
        d = cur - self._hlast
        self._hlast = cur
        self.shard_fail_frac = d[0] / np.maximum(d[1], 1.0)
        thr, hys = cfg.breaker_threshold, cfg.breaker_hysteresis
        if cfg.breaker_scope == "global":
            d_fail, d_att = float(d[0].sum()), float(d[1].sum())
            if d_att <= 0:
                return                  # no fetch attempts -> no evidence
            frac = d_fail / d_att
            if not self.breaker_open and frac >= thr:
                self.breaker_open_shards[:] = True
                self.counters["breaker_trips"] += 1
            elif self.breaker_open and frac <= thr * hys:
                self.breaker_open_shards[:] = False
            return
        evidence = d[1] > 0
        frac = self.shard_fail_frac
        opening = evidence & ~self.breaker_open_shards & (frac >= thr)
        if opening.any():
            self.breaker_open_shards |= opening
            self.counters["breaker_trips"] += int(opening.sum())
        closing = (evidence & self.breaker_open_shards
                   & (frac <= thr * hys))
        self.breaker_open_shards &= ~closing

    def _wait_ready(self, done: _Done):
        """Block on a batch, with a watchdog: a wedged device call raises
        ``TimeoutError`` after ``watchdog_s`` instead of hanging."""
        wd = self.cfg.watchdog_s
        with trace.span("engine.wait"):
            if wd <= 0 or done.ready():
                done.wait()
                return
            deadline = time.time() + wd
            while not done.ready():
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"serving watchdog: in-flight batch still not ready "
                        f"after {wd:.1f}s")
                time.sleep(5e-5)

    def _retire_one(self):
        e = self._inflight.popleft()
        with trace.span("engine.retire", e.tick):
            self._wait_ready(e.done)
            if e.served is None:
                self.latency.record(e.t_sched, time.time(), e.n)
                self.counters["served"] += e.n
                return
            cfg = self.cfg
            sv = e.served.numpy()
            now = time.time()
            real = e.ids >= 0
            ok = real & sv
            if ok.any():
                lat = (now - e.t0s[ok]) * 1e6
                self.latency.record_us(lat)
                self.counters["served"] += int(ok.sum())
                if self.scfg is not None:
                    # serves by owner shard (healthy-shard goodput)
                    np.add.at(self.served_per_shard,
                              e.ids[ok] // self.scfg.shard.num_objs, 1)
                if cfg.deadline_us > 0:
                    self.counters["deadline_misses"] += int(
                        (lat > cfg.deadline_us).sum())
            # unserved slots: bounded retry, else shed (counted) -- a request
            # leaves the system exactly once, as served or as shed
            for i in np.nonzero(real & ~sv)[0]:
                if (cfg.max_retries > 0 and e.att[i] < cfg.max_retries
                        and len(self._retryq) < cfg.retry_queue_cap):
                    self._retryq.append(
                        (int(e.ids[i]), float(e.t0s[i]), int(e.att[i]) + 1))
                    self.counters["fetch_retries"] += 1
                else:
                    self.counters["shed_requests"] += 1

    def drain(self):
        """Block on every in-flight batch (end of a workload)."""
        while self._inflight:
            self._retire_one()

    def flush_retries(self):
        """Drive the retry queue to empty with request-less ticks (end of a
        workload): each tick re-dispatches up to ``batch`` queued retries.
        Bounded: anything still unserved when attempts run out is shed."""
        guard = 4 * (self.cfg.max_retries + 2)
        while True:
            self.drain()
            if not self._retryq or guard <= 0:
                break
            self.submit(_EMPTY_IDS)
            guard -= 1
        while self._retryq:             # guard tripped: shed the leftovers
            self._retryq.popleft()
            self.counters["shed_requests"] += 1

    # -- synchronous convenience wrapper ------------------------------------

    def serve_batch(self, obj_ids) -> torch.Tensor:
        """Serve one batch synchronously; returns the rows."""
        rows = self.submit(obj_ids)
        self.drain()
        return rows

    def run(self, workload: Iterable, offered_interarrival_s: float = 0.0
            ) -> dict:
        """Drain a workload; optional pacing simulates offered load (a
        batch's latency clock starts at its scheduled arrival).  Reports
        goodput (served requests / wall) beside raw throughput ((served +
        shed) / wall)."""
        t_run0 = time.time()
        next_arrival = time.time()
        for batch in workload:
            if offered_interarrival_s:
                t_sched = next_arrival
                while True:
                    now = time.time()
                    if now >= next_arrival:
                        break
                    if self._inflight and self._inflight[0].done.ready():
                        self._retire_one()
                        continue
                    time.sleep(min(2e-4, next_arrival - now))
                next_arrival += offered_interarrival_s
            else:
                t_sched = None
            self.submit(batch, t_sched=t_sched)
        self.drain()
        if self._robust:
            self.flush_retries()
        wall = max(time.time() - t_run0, 1e-9)
        if self.scfg is not None:
            raw = shardplane.stats_total(self.state, self.group)
            pf = shardplane.paging_fraction(self.scfg, self.state,
                                            self.group)
        else:
            raw = self.state.stats
            pf = plane_lib.paging_fraction(self.pcfg, self.state)
        stats = {k: int(v) for k, v in raw._asdict().items()}
        served = self.counters["served"]
        finished = served + self.counters["shed_requests"]
        report = {"latency": self.latency.summary(), "stats": stats,
                  "paging_fraction": float(pf),
                  "counters": dict(self.counters),
                  "goodput_rps": served / wall,
                  "throughput_rps": finished / wall}
        if self.scfg is not None:
            # failures by the shard that performed the fetch (or the write)
            for k in ("fetch_failures", "egress_failures"):
                report[f"{k}_per_shard"] = self._per_shard(
                    lambda s: getattr(s.stats, k)).tolist()
            report["served_per_shard"] = self.served_per_shard.tolist()
        return report
