"""The far-memory key-value store cell: set-up, the measured window, and
the check of what the window served.

Set-up makes the data on the device from the seed, builds the port's
``PlaneConfig`` and ``EngineConfig`` from the configuration file alone,
fills the local tier (uniform keys through ``core.plane.access`` at a
large batch until every frame holds a page), then runs the cell's own
traffic for ``warm_ticks`` ticks.  The window drives
``serving.engine.Engine.submit`` (pipelined dispatch), closed or open
loop.  Every row the window served is kept (a reference to the device
tensor ``submit`` returned, no copy) and judged after the window against
``reference``, together with a seeded sample of keys the window did not
serve, read back through the engine.

With ``trace`` a segment of ``SEGMENT_TICKS`` ticks, begun after
``SEGMENT_AT`` of the window, runs under ``torch.profiler`` with spans
around the engine's parts; host-clock readings come only from the ticks
before it.
"""
from __future__ import annotations

import gc
import math
import time
from collections import deque

import numpy as np
import torch
from repro_torch.core import plane as plane_lib
from repro_torch.core.layout import PlaneConfig
from repro_torch.serving.engine import Engine, EngineConfig

from . import host, reference
from . import trace as trace_lib
from . import traffic as tr

SEGMENT_TICKS = 64          # one evacuation round at evac_every 64
SEGMENT_AT = 0.6            # share of the window before the segment
READBACK = 65536            # keys read back after the window
DRAIN_LIMIT_S = 60.0        # open loop: wait this long past the close
SLOW_SUBMIT_S = 0.25        # a submit this long is logged with its context

clock = time.perf_counter


def plane_config(cfg: dict) -> PlaneConfig:
    """The plane of a configuration file: frames for ``local_fraction`` of
    the data pages, ``vpage_factor`` times their virtual pages."""
    P = int(cfg["page_objs"])
    dp = -(-int(cfg["objects"]) // P)
    return PlaneConfig(num_objs=int(cfg["objects"]), obj_dim=int(cfg["obj_dim"]),
                       page_objs=P,
                       num_frames=max(int(dp * float(cfg["local_fraction"])), 8),
                       num_vpages=int(cfg["vpage_factor"]) * dp,
                       dtype=getattr(torch, cfg["dtype"]),
                       **cfg.get("plane", {}))


def engine_config(cfg: dict) -> EngineConfig:
    return EngineConfig(**cfg["engine"])


class _Marker:
    """Completion of the work queued so far: a CUDA event, or nothing on
    the CPU (eager CPU work is done when the call returns)."""

    def __init__(self, device: torch.device):
        self._ev = None
        if device.type == "cuda":
            self._ev = torch.cuda.Event()
            self._ev.record()

    def ready(self) -> bool:
        return self._ev is None or self._ev.query()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stats(state) -> torch.Tensor:
    """The plane's counters as one int64 vector (enqueued, not synced)."""
    return torch.stack([v.to(torch.int64)
                        for v in state.stats._asdict().values()])


def _delta(state, a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (b - a).cpu().tolist()
    return dict(zip(state.stats._asdict().keys(), d))


class Run:
    """One run of a cell: everything the metrics and the check read."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device, log=print):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.log = log
        self.pcfg = plane_config(cfg)
        self.ecfg = engine_config(cfg)
        self.batch = self.ecfg.batch                 # GETs a tick
        self.served = []            # (keys, rows) of the window
        self.ticks = []             # (host s, ran evacuation) before segment
        self.queue_s = None         # open loop: wait from arrival to submit
        self.segment = None

    # -- set-up -------------------------------------------------------------

    def n_requests(self) -> int:
        """Requests the stream needs: the warm-up, up to one evacuation
        round more until the tier is full, and the window's cap."""
        ev = self.ecfg.evac_every
        warm = (int(self.cfg["warm_ticks"]) + ev) * self.batch
        extra = SEGMENT_TICKS * self.batch if self.trace else 0
        if self.mix["loop"] == "closed":
            cap = math.ceil(float(self.mix["max_requests_per_s"])
                            * self.seconds)
            return warm + cap + extra
        self.arrivals = tr.arrivals(self.mix, self.seed, self.seconds)
        return warm + self.arrivals.size + extra

    def inputs(self) -> None:
        """The data (on the device, from the seed, in one call) and the
        stream of keys: the inputs both the program and the reference get."""
        O, D = self.pcfg.num_objs, self.pcfg.obj_dim
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        self.data = torch.rand((O, D), generator=g, device=self.device,
                               dtype=self.pcfg.dtype)
        self.keys = tr.request_keys(self.cfg["keys"], O, self.seed,
                                    self.n_requests(), self.device)
        self.digest_head = tr.digest(self.keys[:tr.HEAD_KEYS])

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        O = self.pcfg.num_objs
        self.inputs()
        self.eng = Engine(self.ecfg, self.pcfg, self.data, device=dev)
        self.fill_calls = self._fill()
        self.pos = 0                                  # next key
        self.touched = torch.zeros(O, dtype=torch.bool, device=dev)
        self.touched[self.fill_keys] = True
        for _ in range(int(cfg["warm_ticks"])):
            self._submit_keys(self.batch)
        self.eng.drain()
        extra = 0
        while self.occupancy() < 1.0 and extra < self.ecfg.evac_every:
            self._submit_keys(self.batch)
            self.eng.drain()
            extra += 1
        self.warm_extra = extra
        self.touched[self.keys[:self.pos].to(torch.int64)] = True
        _sync(dev)
        # what set-up made stays alive for the run: keep the collector's
        # full passes from walking it inside the window
        gc.collect()
        gc.freeze()

    def _fill(self) -> int:
        """Page in uniform keys at ``fill_batch`` a call until every frame
        holds a page; returns the calls made."""
        pcfg, s = self.pcfg, self.eng.state
        n = int(self.cfg["fill_batch"])
        limit = 8 * pcfg.num_frames * pcfg.page_objs // n + 64
        calls, start, seen = 0, 0, []
        while float(plane_lib.occupancy(pcfg, s)) < 1.0:
            if calls >= limit:
                raise RuntimeError(f"fill: the local tier is not full after "
                                   f"{calls} calls")
            ids = tr.uniform_keys(self.seed, tr.FILL, pcfg.num_objs, start, n,
                                  self.device)
            plane_lib.access(pcfg, s, ids)
            seen.append(ids)
            start += n
            calls += 1
        self.fill_keys = (torch.cat(seen).to(torch.int64) if seen else
                          torch.zeros(0, dtype=torch.int64,
                                      device=self.device))
        return calls

    def occupancy(self) -> float:
        return float(plane_lib.occupancy(self.pcfg, self.eng.state))

    def _submit_keys(self, n: int):
        """Submit the next ``n`` keys of the stream; returns them and the
        rows ``submit`` gave back."""
        k = self.keys[self.pos:self.pos + n]
        self.pos += n
        return k, self.eng.submit(k)

    def _evac_due(self) -> bool:
        """Whether the submit just made ran a foreground evacuation."""
        e = self.ecfg
        return (e.plane == "hybrid" and e.evac_budget == 0
                and self.eng.ticks % e.evac_every == 0)

    # -- the window -----------------------------------------------------------

    def window(self) -> None:
        dev = self.device
        _sync(dev)
        self.occupancy_at_start = self.occupancy()
        if self.occupancy_at_start != 1.0:
            raise RuntimeError(f"local tier occupancy at the window's start "
                               f"is {self.occupancy_at_start}, not 1.0")
        self.stats0 = _stats(self.eng.state)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.host = _HostEvents(self.eng, dev)
        if self.mix["loop"] == "closed":
            self._closed()
        else:
            self._open()
        self.host.close(self.eng)
        self.window_stats = _delta(self.eng.state, self.stats0,
                                   _stats(self.eng.state))

    def _tick(self, n: int, segment: bool):
        mark = self.host.mark()
        t0 = clock()
        k, rows = self._submit_keys(n)
        dt = clock() - t0
        if dt >= SLOW_SUBMIT_S:
            self.host.slow(mark, dt, t0 - self._t0, self.eng.ticks,
                           self._evac_due())
        self.served.append((k, rows))
        if not segment and self.segment is None:
            self.ticks.append((dt, self._evac_due()))
        return True

    def _closed(self) -> None:
        cap = self.keys.shape[0] - (SEGMENT_TICKS * self.batch
                                    if self.trace else 0)
        seg_at = SEGMENT_AT * self.seconds if self.trace else math.inf
        t0 = self._t0 = clock()
        while True:
            now = clock() - t0
            if now >= self.seconds:
                break
            if self.pos + self.batch > cap:
                self.log(f"[bench] the window ran out of keys at {now:.3f} s"
                         f" (max_requests_per_s is too low)")
                break
            if now >= seg_at and self.segment is None:
                self._segment(self._segment_tick)
                continue
            self._tick(self.batch, False)
        self.eng.drain()
        _sync(self.device)
        self.window_s = clock() - t0
        if self.trace and self.segment is None:
            self._segment(self._segment_tick)

    def _segment_tick(self):
        if self.pos + self.batch > self.keys.shape[0]:
            return None
        with trace_lib.span("bench.submit"):
            return self._tick(self.batch, True)

    def _segment(self, step) -> None:
        """``step`` under the profiler until it has submitted
        ``SEGMENT_TICKS`` ticks (or returns None: nothing is left to
        submit), with the plane's counters snapshotted at both ends (in
        stream order)."""
        eng, dev = self.eng, self.device
        before = (clock() - self._t0, len(self.ticks))
        eng.drain()
        _sync(dev)
        a = _stats(eng.state)
        pos = self.pos
        with trace_lib.profiled(dev) as prof, trace_lib.spans(eng):
            with trace_lib.span("bench.window"):
                ticks = 0
                while ticks < SEGMENT_TICKS:
                    done = step()
                    if done is None:
                        break
                    ticks += done
                b = _stats(eng.state)
                _sync(dev)
        self.segment = {"ticks": ticks, "prof": prof, "before": before,
                        "stats": _delta(eng.state, a, b),
                        "keys": int((self.keys[pos:self.pos] >= 0).sum())}

    def _open(self) -> None:
        """Poisson arrivals; each submit carries what has arrived, up to the
        batch.  A request's latency runs from its arrival to the moment the
        loop sees its batch complete (a marker recorded after ``submit``
        returns)."""
        B, dev = self.batch, self.device
        arr = self.arrivals
        n = arr.size
        base = self.pos                         # request index of arr[0]
        comp = np.full(n, np.nan)
        sub = np.full(n, np.nan)
        pend = deque()
        seg_at = SEGMENT_AT * self.seconds if self.trace else math.inf
        seg_i = n                               # first request of segment
        i = 0
        t0 = self._t0 = clock()
        late = t0 + self.seconds + DRAIN_LIMIT_S

        def poll(now):
            while pend and pend[0][0].ready():
                _, a, b = pend.popleft()
                comp[a:b] = now

        def submit(now, segment):
            nonlocal i
            k = int(np.searchsorted(arr, now, side="right"))
            j = min(k, i + B)
            sub[i:j] = now
            self.pos = base + i
            self._tick(j - i, segment)
            pend.append((_Marker(dev), i, j))
            i = j
            return True

        def step():
            t = clock() - t0
            poll(t)
            if i >= n:
                return None
            if arr[i] <= t:
                with trace_lib.span("bench.submit"):
                    return submit(t, True)
            with trace_lib.span("bench.wait"):
                _wait_until(t0, arr, i, n)
            return False

        while i < n or pend:
            now = clock() - t0
            poll(now)
            if clock() > late:
                break
            if i < n and arr[i] <= now:
                if now >= seg_at and self.segment is None:
                    seg_i = i
                    self._segment(step)
                    continue
                submit(now, False)
            else:
                _wait_until(t0, arr, i, n)
        self.eng.drain()
        _sync(dev)
        poll(clock() - t0)
        self.window_s = clock() - t0
        self.pos = base + n
        self.latency_s = comp - arr             # NaN: never completed
        self.queue_s = (sub - arr)[:seg_i]
        self.attempted = n

    # -- after the window -----------------------------------------------------

    def check(self) -> dict:
        """Read back a sample the window did not serve, read the peak, free
        the program's state, then judge everything against the reference."""
        dev, O = self.device, self.pcfg.num_objs
        served_mask = torch.zeros(O, dtype=torch.bool, device=dev)
        for k, _ in self.served:
            served_mask[k[k >= 0].to(torch.int64)] = True
        before = (self.touched & ~served_mask).nonzero().flatten()
        never = (~self.touched & ~served_mask).nonzero().flatten()
        picks = []
        for j, cand in enumerate((before, never)):
            if cand.numel():
                r = tr.below(tr.stream(self.seed, tr.SAMPLE, j * READBACK,
                                       READBACK // 2, dev), cand.numel())
                picks.append(cand[r])
        sample = (torch.cat(picks).to(torch.int32) if picks else
                  torch.zeros(0, dtype=torch.int32, device=dev))
        readback = []
        for a in range(0, sample.shape[0], self.batch):
            k = sample[a:a + self.batch]
            readback.append((k, self.eng.submit(k)))
        self.eng.drain()
        _sync(dev)
        gc.unfreeze()
        self.memory_peak = (torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0)
        del self.eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        got = reference.compare(self.data, self.served)
        back = reference.compare(self.data, readback)
        missing = 0
        if self.mix["loop"] == "open":
            missing = int(np.isnan(self.latency_s).sum())
        self.correct_rows = got["rows"] - got["rows_wrong"]
        if self.mix["loop"] == "closed":
            self.attempted = got["rows"]
        checks = {"rows_wrong": got["rows_wrong"],
                  "max_abs_gap": max(got["max_abs_gap"], back["max_abs_gap"]),
                  "readback_wrong": back["rows_wrong"],
                  "missing": missing}
        self.rows_judged = got["rows"] + back["rows"]
        self.checks = {k: (v, reference.LIMITS[k]) for k, v in checks.items()}
        return self.checks

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())

    @property
    def failed(self) -> int:
        return int(self.checks["rows_wrong"][0] + self.checks["missing"][0])

    # -- what the run logs ----------------------------------------------------

    def log_setup(self, name: str, setup_s: float, build_s: float,
                  kind: str) -> None:
        log, cfg = self.log, self.cfg
        log(f"[bench] {name} seed {self.seed}: {cfg['objects']} objects, "
            f"{self.fill_calls} fill calls, {cfg['warm_ticks']} + "
            f"{self.warm_extra} warm ticks; kernel build "
            f"{build_s:.1f} s; set-up {setup_s:.3f} s on {kind}")
        log(f"[bench] traffic digest: {self.digest_head} (the first "
            f"{tr.HEAD_KEYS} of {self.keys.shape[0]} keys)")

    def log_window(self) -> None:
        log = self.log
        log(f"[bench] local tier occupancy at the window's start: "
            f"{self.occupancy_at_start}")
        log(f"[bench] window {self.window_s:.3f} s, {len(self.served)} "
            f"submits, plane counters {self.window_stats}")
        log(f"[bench] host events in the window: {self.host.window}")
        for slow in self.host.slow_submits:
            log(f"[bench] slow submit: {slow}")
        if len(self.ticks) >= 4:
            t = sorted(s for s, _ in self.ticks)
            q = [t[int(f * (len(t) - 1))] * 1e3
                 for f in (0.25, 0.5, 0.75, 0.99)]
            log(f"[bench] host ms a submit: quartiles {q[0]:.2f} {q[1]:.2f} "
                f"{q[2]:.2f}, p99 {q[3]:.2f}, max {t[-1] * 1e3:.2f} "
                f"({len(t)} submits before any traced segment)")

    def log_checked(self) -> None:
        self.log(f"[bench] {self.rows_judged} rows judged against the "
                 f"reference; correct: {self.correct}")

    def end_to_end(self) -> dict:
        """The end-to-end readings of this run (host clock)."""
        out = {}
        if self.mix["loop"] == "closed":
            out["requests_per_s"] = self.correct_rows / self.window_s
        else:
            lat = self.latency_s[~np.isnan(self.latency_s)]
            if lat.size:
                out["p99_ms"] = float(np.percentile(lat, 99)) * 1e3
        return out


def record(run: Run, tr, peaks: dict) -> dict:
    """What the per-layer readers of a store cell read."""
    seg = None
    if run.segment is not None:
        seg = {"ticks": run.segment["ticks"], "stats": run.segment["stats"],
               "keys": run.segment["keys"], "trace": tr,
               "before": run.segment["before"]}
    return {"ticks": run.ticks, "queue_s": run.queue_s,
            "window_stats": run.window_stats, "segment": seg,
            "row_bytes": run.pcfg.row_bytes,
            "page_bytes": run.pcfg.page_bytes,
            "hbm_bytes_per_s": peaks.get("hbm_bytes_per_s")}


class _HostEvents:
    """What the host did around the window's submits: process CPU time,
    the time spent waiting for the device inside the engine, page faults,
    the collector's passes, the allocator's segments and retries and the
    machine's steal time over the window, and the same around each submit
    that takes ``SLOW_SUBMIT_S`` or more (logged with its place)."""

    def __init__(self, eng, device: torch.device):
        self.device = device
        self.gc_n, self.gc_s, self._gc_t = 0, 0.0, None
        self.wait_s = 0.0
        self.slow_submits = []
        wait = eng._wait_ready

        def timed_wait(done):
            t = clock()
            try:
                return wait(done)
            finally:
                self.wait_s += clock() - t
        eng._wait_ready = timed_wait
        gc.callbacks.append(self._on_gc)
        self.start = self.mark()
        self.alloc0 = self._alloc()

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t = clock()
        elif self._gc_t is not None:
            self.gc_n += 1
            self.gc_s += clock() - self._gc_t
            self._gc_t = None

    def _alloc(self) -> tuple:
        """The allocator's segments allocated and retries so far, and the
        machine's steal time (s) so far, where the system reports it."""
        segs = retries = 0
        if self.device.type == "cuda":
            st = torch.cuda.memory_stats(self.device)
            segs = int(st.get("segment.all.allocated", 0))
            retries = int(st.get("num_alloc_retries", 0))
        return segs, retries, host.steal_s()

    def _alloc_since(self, a: tuple) -> dict:
        now = self._alloc()
        return {"segments_allocated": now[0] - a[0],
                "alloc_retries": now[1] - a[1],
                "steal_s": round(now[2] - a[2], 3)}

    def mark(self) -> tuple:
        u = host.usage()
        return (u["cpu_s"], self.wait_s, u["minor_faults"],
                u["major_faults"], self.gc_n, self.gc_s)

    def _since(self, m: tuple) -> dict:
        now = self.mark()
        return {"cpu_s": round(now[0] - m[0], 6),
                "device_wait_s": round(now[1] - m[1], 6),
                "minor_faults": now[2] - m[2], "major_faults": now[3] - m[3],
                "gc_passes": now[4] - m[4], "gc_s": round(now[5] - m[5], 6)}

    def slow(self, m: tuple, host_s: float, at_s: float, tick: int,
             evac: bool) -> None:
        """A slow submit; the allocator's and steal readings count from the
        window's start."""
        self.slow_submits.append(dict(
            tick=tick, at_s=round(at_s, 3), host_s=round(host_s, 6),
            evacuation=evac, **self._since(m),
            since_start=self._alloc_since(self.alloc0)))

    def close(self, eng) -> None:
        gc.callbacks.remove(self._on_gc)
        del eng._wait_ready
        self.window = dict(self._since(self.start),
                           **self._alloc_since(self.alloc0))


def _wait_until(t0: float, arr: np.ndarray, i: int, n: int) -> None:
    """Sleep towards the next arrival, at most 100 us at a time."""
    nxt = arr[i] if i < n else math.inf
    time.sleep(max(0.0, min(nxt - (clock() - t0), 1e-4)))

