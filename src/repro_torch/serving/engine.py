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
breaker a tick late, as in JAX.  Not ported yet, and refused with
``NotImplementedError``: the sharded far tier (``shards > 1``).
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
from ..core import state as state_lib
from ..core.layout import PlaneConfig


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

    @property
    def lat_us(self) -> list:
        return self._buf[:min(self.n, self.capacity)].tolist()

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


_EMPTY_IDS = np.empty((0,), np.int32)


class Engine:
    """Continuous-batching serving engine (one device).

    ``submit`` enqueues one batch (plan + execute) and returns its rows (a
    device tensor, complete once the batch retires); ``drain`` blocks on
    everything still in flight; ``serve_batch`` is submit + drain."""

    def __init__(self, cfg: EngineConfig, pcfg: PlaneConfig, initial,
                 device="cuda"):
        if cfg.plane not in ("hybrid", "paging", "object"):
            raise ValueError(cfg.plane)
        if cfg.shards > 1:
            raise NotImplementedError("shards > 1: the sharded far tier is "
                                      "not ported yet")
        if cfg.faults is not None:
            # the schedule rides in the plane config, as in JAX
            pcfg = dataclasses.replace(pcfg, faults=cfg.faults)
        self.cfg = cfg
        self.pcfg = pcfg
        self.device = state_lib.resolve_device(device)
        self.state = state_lib.create(pcfg, initial, device=self.device)
        self._robust = (cfg.faults is not None or cfg.deadline_us > 0
                        or cfg.max_retries > 0 or cfg.breaker_threshold > 0)
        self._breaker_on = self._robust and cfg.breaker_threshold > 0
        self.reclaim = None
        if cfg.plane == "hybrid":
            self._plan_kw, self._exec = {}, batch_lib.execute_access
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
        self._epoch_on = cfg.plane == "hybrid" and (
            cfg.epoch_every > 0 or cfg.epoch_watermark_bytes > 0)
        if cfg.plane == "hybrid" and cfg.evac_budget > 0:
            slices = -(-16 // cfg.evac_budget)          # ceil(16/budget)
            self._evac_slice_period = max(1, cfg.evac_every // slices)
            self._evac_round = 0        # last round whose access-clear ran
        self._probe = None              # in-flight traffic watermark read
        self._hprobe = None             # in-flight health probe read
        self._hlast = np.zeros((2, cfg.shards), np.float64)
        self.shard_fail_frac = np.zeros((cfg.shards,), np.float64)
        self.breaker_open_shards = np.zeros((cfg.shards,), bool)
        self._retryq: deque = deque()   # (obj_id, t0, attempt)
        self.counters = {"served": 0, "fetch_retries": 0, "shed_requests": 0,
                         "deadline_misses": 0, "degraded_ticks": 0,
                         "breaker_trips": 0}
        self.latency = LatencyTracker()
        self.ticks = 0
        self._inflight: deque[_Inflight] = deque()      # oldest-first
        # the JAX engine warms its compiled paths with one all-zeros batch
        # and, on the hybrid plane, one foreground evacuation; both change
        # the state, so the port runs them too (and the first call builds
        # the kernels).  The degraded plan is warmed and discarded, as in
        # JAX: a plan reads the state and never writes it.  Then the
        # counters are zeroed exactly as the JAX engine does.
        warm = torch.zeros((cfg.batch,), dtype=torch.int32,
                           device=self.device)
        self._exec(pcfg, self.state, warm, self._plan(warm), mode=cfg.mode)
        if cfg.plane == "hybrid":
            plane_lib.evacuate(pcfg, self.state)
        if self._breaker_on:
            self._plan(warm, degraded=True)
        s = self.state
        s.stats = state_lib.PlaneStats.zeros(self.device)
        s.epoch_page_ins = torch.zeros_like(s.epoch_page_ins)
        s.epoch_obj_ins = torch.zeros_like(s.epoch_obj_ins)

    def _plan(self, ids: torch.Tensor, degraded: bool = False):
        return batch_lib.plan_access(self.pcfg, self.state, ids,
                                     degraded=degraded, **self._plan_kw)

    @property
    def breaker_open(self) -> bool:
        """True if the (single shard's) breaker is open."""
        return bool(self.breaker_open_shards.any())

    # -- pipelined dispatch -------------------------------------------------

    def submit(self, obj_ids, t_sched: float | None = None) -> torch.Tensor:
        """Enqueue one batch; returns its rows.  Blocks only when more than
        ``pipeline_depth`` batches are in flight, never on this batch."""
        t_sched = time.time() if t_sched is None else t_sched
        # opportunistic retirement of anything already finished
        while self._inflight and self._inflight[0].done.ready():
            self._retire_one()
        if self._robust:
            rows = self._submit_robust(obj_ids, t_sched)
        else:
            rows = self._dispatch(obj_ids, t_sched)
        self.ticks += 1
        self._maintenance()
        limit = 0 if self.cfg.dispatch == "sync" else self.cfg.pipeline_depth
        while len(self._inflight) > limit:
            self._retire_one()
        return rows

    def _ids(self, obj_ids) -> torch.Tensor:
        """The batch's ids as an int32 [batch] device tensor, short batches
        padded with the plane's negative-id no-ops (fixed shapes)."""
        B = self.cfg.batch
        if isinstance(obj_ids, torch.Tensor):
            ids = obj_ids.to(self.device, torch.int32).reshape(-1)
        else:
            host = torch.from_numpy(np.ascontiguousarray(obj_ids, np.int32))
            if self.device.type == "cuda":
                host = host.pin_memory()
            ids = host.to(self.device, non_blocking=True).reshape(-1)
        n = ids.shape[0]
        if n > B:
            raise ValueError(f"batch of {n} > configured batch={B}")
        if n < B:
            ids = torch.cat([ids, torch.full((B - n,), -1, dtype=torch.int32,
                                             device=self.device)])
        return ids

    def _dispatch(self, obj_ids, t_sched):
        ids = self._ids(obj_ids)
        n = len(obj_ids)
        plan = self._plan(ids)
        _, rows_full = self._exec(self.pcfg, self.state, ids, plan,
                                  mode=self.cfg.mode)
        self._inflight.append(_Inflight(rows_full, _Done(self.device),
                                        t_sched, n))
        return rows_full[:n] if n < self.cfg.batch else rows_full

    def _submit_robust(self, obj_ids, t_sched):
        """Chaos-mode dispatch: deadline shed at admission, retry slots in
        the batch tail, per-slot served verdicts, circuit-breaker routing.
        ``obj_ids`` is read on the host (a device tensor is copied back)."""
        cfg = self.cfg
        if isinstance(obj_ids, torch.Tensor):
            obj_ids = obj_ids.cpu().numpy()
        ids_np = np.asarray(obj_ids, np.int32).reshape(-1)
        n = ids_np.size
        if n > cfg.batch:
            raise ValueError(f"batch of {n} > configured batch={cfg.batch}")
        now = time.time()
        shedding = cfg.deadline_us > 0 and cfg.shed_policy == "deadline"
        shed = shedding and n > 0 and (now - t_sched) * 1e6 > cfg.deadline_us
        if shed:
            # the whole arrival is already past its SLO: count it out
            self.counters["shed_requests"] += n
            self.counters["deadline_misses"] += n
        full = np.full((cfg.batch,), -1, np.int32)
        t0s = np.full((cfg.batch,), now, np.float64)
        att = np.zeros((cfg.batch,), np.int32)
        k = 0
        if n and not shed:
            # new requests first: rows[:n] stay aligned with the caller's ids
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
        tick = self.ticks + 1
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
        # an open breaker serves local hits only, except on probe ticks
        degraded = False
        if (self._breaker_on and self.breaker_open
                and tick % cfg.breaker_probe_every != 0):
            degraded = True
            self.counters["degraded_ticks"] += 1
        ids = self._ids(full)
        plan = self._plan(ids, degraded=degraded)
        _, rows_full = self._exec(self.pcfg, self.state, ids, plan,
                                  mode=cfg.mode)
        served = _to_host(plan.served)
        self._inflight.append(_Inflight(rows_full, _Done(self.device),
                                        t_sched, n, served, full, t0s, att))
        if self._breaker_on:
            self._breaker_step()
        if shed:
            return torch.zeros((n, rows_full.shape[1]), dtype=rows_full.dtype,
                               device=self.device)
        return rows_full[:n] if n < cfg.batch else rows_full

    def _maintenance(self):
        """Per-tick background work on the hybrid plane (evacuation
        slices, epoch governor)."""
        cfg, pcfg, s = self.cfg, self.pcfg, self.state
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
                plane_lib.evacuate(pcfg, s, max_pages=cfg.evac_budget,
                                   clear_access=clear)
        elif self.ticks % cfg.evac_every == 0:
            plane_lib.evacuate(pcfg, s)
        if self._epoch_on and self._epoch_due():
            plane_lib.advance_epoch(pcfg, s)
            self._probe = None          # watermark restarts from the epoch

    def _traffic(self) -> torch.Tensor:
        """Bytes moved (paging + object ingress) since the last epoch."""
        s, pcfg = self.state, self.pcfg
        return ((s.stats.page_ins - s.epoch_page_ins).to(torch.float32)
                * float(pcfg.page_bytes)
                + (s.stats.obj_ins - s.epoch_obj_ins).to(torch.float32)
                * float(pcfg.row_bytes))

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
        """Cumulative (failed, attempted) remote fetches, ``[2, 1]`` f32,
        copied to the host behind an event.  Attempts are successful
        ingress plus failures, so a window's fraction measures its probe
        ticks' health."""
        st = self.state.stats
        h = torch.stack([st.fetch_failures,
                         st.page_ins + st.obj_ins + st.fetch_failures]
                        ).to(torch.float32).reshape(2, 1)
        return _to_host(h), _Done(self.device)

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
        stats = {k: int(v) for k, v in self.state.stats._asdict().items()}
        served = self.counters["served"]
        finished = served + self.counters["shed_requests"]
        return {"latency": self.latency.summary(), "stats": stats,
                "paging_fraction": float(
                    plane_lib.paging_fraction(self.pcfg, self.state)),
                "counters": dict(self.counters),
                "goodput_rps": served / wall,
                "throughput_rps": finished / wall}
