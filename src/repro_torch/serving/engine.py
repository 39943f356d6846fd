"""Serving engine: continuous batching over the hybrid plane (PyTorch port
of ``repro.serving.engine``).

The engine serves key-value GET requests against a far-memory-resident
object store managed by the hybrid plane.  Each batch is submitted as two
calls on the device's stream, ``plan_access`` then ``execute_access``,
which never sync with the host.  ``dispatch="pipelined"`` (default) keeps
up to ``pipeline_depth`` batches in flight and blocks only on the oldest
one; ``dispatch="sync"`` retires every batch at once.  Both produce the
same rows and plane state.  JAX's ``is_ready()`` becomes a CUDA event
recorded after each call and polled with ``Event.query()`` (on the CPU
every call has finished when it returns).

Background evacuation (``evac_budget``) and the epoch governor
(``epoch_every``, ``epoch_watermark_bytes``) run between batches as in the
JAX engine.  Not ported yet, and refused with ``NotImplementedError``: the
``paging``/``object`` baseline planes, the sharded far tier
(``shards > 1``) and the robust path (``faults``, ``deadline_us``,
``max_retries``, ``breaker_threshold``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable, NamedTuple

import numpy as np
import torch

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
    reclaim_free_target: int = 2    # object plane
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


class _Inflight(NamedTuple):
    """One dispatched batch awaiting retirement."""
    rows: torch.Tensor      # [batch, D] on the device
    done: _Done
    t_sched: float          # batch scheduled-arrival clock
    n: int                  # caller's request count (first n slots)


class Engine:
    """Continuous-batching serving engine (one device, hybrid plane).

    ``submit`` enqueues one batch (plan + execute) and returns its rows (a
    device tensor, complete once the batch retires); ``drain`` blocks on
    everything still in flight; ``serve_batch`` is submit + drain."""

    def __init__(self, cfg: EngineConfig, pcfg: PlaneConfig, initial,
                 device="cuda"):
        if cfg.plane != "hybrid":
            raise NotImplementedError(
                f"plane={cfg.plane!r}: the paging/object baselines are not "
                f"ported yet (hybrid only)")
        if cfg.shards > 1:
            raise NotImplementedError("shards > 1: the sharded far tier is "
                                      "not ported yet")
        if (cfg.faults is not None or cfg.deadline_us > 0
                or cfg.max_retries > 0 or cfg.breaker_threshold > 0):
            raise NotImplementedError(
                "the robust serving path (faults, deadline_us, max_retries, "
                "breaker_threshold) is not ported yet")
        self.cfg = cfg
        self.pcfg = pcfg
        self.device = state_lib.resolve_device(device)
        self.state = state_lib.create(pcfg, initial, device=self.device)
        self._epoch_on = cfg.epoch_every > 0 or cfg.epoch_watermark_bytes > 0
        if cfg.evac_budget > 0:
            slices = -(-16 // cfg.evac_budget)          # ceil(16/budget)
            self._evac_slice_period = max(1, cfg.evac_every // slices)
            self._evac_round = 0        # last round whose access-clear ran
        self._probe = None              # in-flight traffic watermark read
        self.counters = {"served": 0}
        self.latency = LatencyTracker()
        self.ticks = 0
        self._inflight: deque[_Inflight] = deque()      # oldest-first
        # the JAX engine warms its compiled paths with one all-zeros batch
        # and one foreground evacuation; both change the state, so the port
        # runs them too (and the first call builds the kernels), then zeroes
        # the counters exactly as the JAX engine does
        warm = torch.zeros((cfg.batch,), dtype=torch.int32,
                           device=self.device)
        plan = batch_lib.plan_access(pcfg, self.state, warm)
        batch_lib.execute_access(pcfg, self.state, warm, plan, mode=cfg.mode)
        plane_lib.evacuate(pcfg, self.state)
        s = self.state
        s.stats = state_lib.PlaneStats.zeros(self.device)
        s.epoch_page_ins = torch.zeros_like(s.epoch_page_ins)
        s.epoch_obj_ins = torch.zeros_like(s.epoch_obj_ins)

    # -- pipelined dispatch -------------------------------------------------

    def submit(self, obj_ids, t_sched: float | None = None) -> torch.Tensor:
        """Enqueue one batch; returns its rows.  Blocks only when more than
        ``pipeline_depth`` batches are in flight, never on this batch."""
        t_sched = time.time() if t_sched is None else t_sched
        # opportunistic retirement of anything already finished
        while self._inflight and self._inflight[0].done.ready():
            self._retire_one()
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
        plan = batch_lib.plan_access(self.pcfg, self.state, ids)
        _, rows_full = batch_lib.execute_access(self.pcfg, self.state, ids,
                                                plan, mode=self.cfg.mode)
        self._inflight.append(_Inflight(rows_full, _Done(self.device),
                                        t_sched, n))
        return rows_full[:n] if n < self.cfg.batch else rows_full

    def _maintenance(self):
        """Per-tick background work (evacuation slices, epoch governor)."""
        cfg, pcfg, s = self.cfg, self.pcfg, self.state
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
        self.latency.record(e.t_sched, time.time(), e.n)
        self.counters["served"] += e.n

    def drain(self):
        """Block on every in-flight batch (end of a workload)."""
        while self._inflight:
            self._retire_one()

    # -- synchronous convenience wrapper ------------------------------------

    def serve_batch(self, obj_ids) -> torch.Tensor:
        """Serve one batch synchronously; returns the rows."""
        rows = self.submit(obj_ids)
        self.drain()
        return rows

    def run(self, workload: Iterable, offered_interarrival_s: float = 0.0
            ) -> dict:
        """Drain a workload; optional pacing simulates offered load (a
        batch's latency clock starts at its scheduled arrival)."""
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
        wall = max(time.time() - t_run0, 1e-9)
        stats = {k: int(v) for k, v in self.state.stats._asdict().items()}
        served = self.counters["served"]
        return {"latency": self.latency.summary(), "stats": stats,
                "paging_fraction": float(
                    plane_lib.paging_fraction(self.pcfg, self.state)),
                "counters": dict(self.counters),
                "goodput_rps": served / wall,
                "throughput_rps": served / wall}
