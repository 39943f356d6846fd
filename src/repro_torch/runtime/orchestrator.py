"""The training orchestrator (port of ``repro.runtime.orchestrator``): the
control plane around the step —

  * checkpoint/restart: periodic async saves, resume from ``latest()``,
    step-indexed data (no replay drift), a final save at the end
  * failure handling: a ``FailureInjector`` simulates node loss; recovery
    restores the newest checkpoint (or the initial state)
  * straggler accounting: a per-step wall-time EWMA; a step slower than
    ``straggler_factor`` x the EWMA is counted
  * deterministic restart: the data stream is derived from the global step

The state is a tree of tensors on one device.  The step may update it in
place, so every start and restart trains on a fresh copy, on the state's
device, of the host snapshot of the initial state (JAX keeps that snapshot
because a jitted step may donate its buffers) or of the newest checkpoint;
neither the snapshot nor the caller's state is trained on.  Each step ends
with a sync of that device, where JAX blocks until the first leaf is
ready.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import ckpt as ckpt_lib
from ..core import faults
from ..tree import device_of, tree_map


class FailureInjector:
    """Deterministic failure schedule for tests and drills.

    A host-side view over the plane-wide fault model
    (:class:`repro_torch.core.faults.Schedule`): ``fail_at_steps`` become
    the schedule's explicit ``fail_at`` ticks, and a full ``schedule``
    adds seeded per-step node loss (``fail_prob``) and outage windows.
    Each step fires at most once (a restarted step must not fail
    forever)."""

    def __init__(self, fail_at_steps=(),
                 schedule: Optional[faults.Schedule] = None):
        extra = tuple(int(s) for s in fail_at_steps)
        if schedule is None:
            schedule = faults.Schedule(fail_at=extra)
        elif extra:
            schedule = dataclasses.replace(
                schedule, fail_at=tuple(schedule.fail_at) + extra)
        self.schedule = schedule
        self.failures = 0
        self._fired: set = set()

    def check(self, step: int):
        step = int(step)
        if step in self._fired:
            return
        if self.schedule.fails(step):
            self._fired.add(step)
            self.failures += 1
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class OrchestratorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    ewma: float = 0.9


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Orchestrator:
    """Runs ``train_step`` with checkpointing, failure recovery and
    straggler accounting.

    ``train_step(state, batch) -> (state, metrics)`` where ``state`` is a
    tree of tensors holding the trainable state and ``batch_fn(step)``
    yields the (deterministic) batch of a global step."""

    def __init__(self, cfg: OrchestratorConfig, train_step: Callable,
                 batch_fn: Callable[[int], Any],
                 injector: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.injector = injector or FailureInjector()
        self.saver = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
        self.metrics = {"steps": 0, "restarts": 0, "stragglers": 0,
                        "step_times": []}
        self._ewma_t = None

    # -- checkpoint/restart ------------------------------------------------
    def resume_or_init(self, init_state, device=None):
        """(state, next step): the newest checkpoint, else a copy of
        ``init_state``, on ``device`` (``init_state``'s by default)."""
        dev = device_of(init_state) if device is None else device
        step = ckpt_lib.latest(self.cfg.ckpt_dir)
        if step is None:
            return tree_map(lambda x: torch.as_tensor(x).to(
                dev, copy=True), init_state), 0
        state, extra = ckpt_lib.restore(self.cfg.ckpt_dir, step, init_state,
                                        device=dev)
        return state, int(extra.get("next_step", step))

    # -- main loop ----------------------------------------------------------
    def run(self, init_state, num_steps: int, *, max_restarts: int = 10):
        dev = device_of(init_state)
        # the live state is always a copy (resume_or_init), so the snapshot
        # may share a host tensor's storage
        init_host = tree_map(lambda x: torch.as_tensor(x).detach().cpu(),
                             init_state)
        state, start = self.resume_or_init(init_host, dev)
        step = start
        restarts = 0
        while step < num_steps:
            try:
                state, step = self._run_span(state, step, num_steps, dev)
            except RuntimeError:
                # node failure: recover from the last checkpoint boundary —
                # but first let any in-flight async save land, or the
                # newest checkpoint stays an unpublished .tmp dir
                restarts += 1
                self.metrics["restarts"] = restarts
                if restarts > max_restarts:
                    raise
                self.saver.wait()
                state, step = self.resume_or_init(init_host, dev)
        self.saver.save(step, state, extra={"next_step": step}, block=True)
        return state

    def _run_span(self, state, step, num_steps, dev):
        while step < num_steps:
            batch = self.batch_fn(step)
            t0 = time.time()
            self.injector.check(step)
            state, metrics = self.train_step(state, batch)
            _sync(dev)
            dt = time.time() - t0
            self._track_time(dt)
            step += 1
            self.metrics["steps"] += 1
            if step % self.cfg.ckpt_every == 0:
                self.saver.save(step, state, extra={"next_step": step})
        return state, step

    def _track_time(self, dt: float):
        self.metrics["step_times"].append(dt)
        if self._ewma_t is None:
            self._ewma_t = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma_t:
            self.metrics["stragglers"] += 1
        self._ewma_t = self.cfg.ewma * self._ewma_t + (1 - self.cfg.ewma) * dt
