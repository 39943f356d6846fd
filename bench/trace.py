"""The traced segment: ``torch.profiler`` over a few ticks, spans around
the calls into the engine's parts, and the reduction of the profiler's
trace to device operations, busy time and idle gaps.

The spans are the benchmark's own: ``bench.*`` around what the harness
does, ``engine.*`` around the engine's plan, execute, evacuate, epoch and
retire calls, wrapped on the instance for the segment only (an engine
without one of them is simply not wrapped there).
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ENGINE_PARTS = {"_plan": "engine.plan", "_exec": "engine.execute",
                "_evac": "engine.evacuate", "_epoch": "engine.epoch",
                "_retire_one": "engine.retire"}
TOP = 10


def span(name: str):
    """A named range in the profiler's trace (a no-op when not profiling)."""
    return torch.profiler.record_function(name)


def _activities(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiled(device: torch.device):
    """The profiler over the block.  Its first start in a process sets up
    the tracer (and leaves every later launch slower), so the segment
    comes after every host-clock reading of the run."""
    prof = torch.profiler.profile(activities=_activities(device))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def wrap(fn, label):
    @functools.wraps(fn)
    def inner(*a, **kw):
        with span(label):
            return fn(*a, **kw)
    return inner


@contextlib.contextmanager
def spans(eng):
    """Spans around the engine's parts for the duration of the block."""
    saved = {}
    for attr, label in ENGINE_PARTS.items():
        fn = getattr(eng, attr, None)
        if callable(fn):
            saved[attr] = attr in vars(eng)
            setattr(eng, attr, wrap(fn, label))
    try:
        yield
    finally:
        for attr, own in saved.items():
            if own:
                setattr(eng, attr, getattr(eng, attr).__wrapped__)
            else:
                delattr(eng, attr)


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for j, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            cut = j
            break
    return name[:cut][:120]


def read(prof) -> dict | None:
    """The segment's trace: device operations ``(name, start us, dur us)``
    inside the ``bench.window`` span, the window's length, the device's
    busy time (the union of its operations), and host spans and operators
    for naming idle gaps.  None when the trace holds no window."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    win, dev, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((name, ts, dur))
        elif cat in ("user_annotation", "cpu_op"):
            if name == "bench.window":
                win, tid = (ts, ts + dur), e.get("tid")
            host.append((cat, name, ts, dur, e.get("tid")))
    if win is None:
        return None
    # the harness's thread: its spans and operators nest properly
    spans_ = [(n, s, d) for c, n, s, d, t in host if t == tid
              and c == "user_annotation" and n.startswith(("bench.",
                                                             "engine."))]
    ops = [(n, s, d) for c, n, s, d, t in host if t == tid and c == "cpu_op"]
    a, b = win
    dev = [(n, max(s, a), min(s + d, b) - max(s, a)) for n, s, d in dev
           if s + d > a and s < b]
    dev.sort(key=lambda x: x[1])
    merged = []
    for _, s, d in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], a
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if b > prev:
        gaps.append((prev, b))
    return {"window_s": (b - a) * 1e-6, "busy_s": busy * 1e-6,
            "device_ops": dev, "gaps": gaps, "spans": spans_, "ops": ops}


def _innermost(events, points) -> list:
    """For each of the increasing ``points``, the name of the innermost of
    the properly nested ``events`` ``(name, start, dur)`` that holds it,
    or None: one sweep with a stack of open events."""
    events = sorted(events, key=lambda e: (e[1], -e[2]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(events) and events[j][1] <= t:
            name, s, d = events[j]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((name, s + d))
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def _labels(tr: dict) -> list:
    """``(seconds, what the host was doing)`` for every idle gap: the
    innermost span and operator at its midpoint."""
    mids = [0.5 * (s + e) for s, e in tr["gaps"]]
    sp = _innermost(tr["spans"], mids)
    op = _innermost(tr["ops"], mids)
    return [((e - s) * 1e-6, f"{a or 'none'}/{o or 'python'}")
            for (s, e), a, o in zip(tr["gaps"], sp, op)]


def breakdown(tr: dict) -> dict:
    """The device operations that took most time, and idle time summed by
    what the host was doing, each at most ``TOP``."""
    by_op, by_gap = {}, {}
    for name, _, d in tr["device_ops"]:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + d * 1e-6
    for sec, label in _labels(tr):
        by_gap[label] = by_gap.get(label, 0.0) + sec
    return {"device_ops": _top(by_op), "idle_gaps": _top(by_gap)}


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def longest_gaps(tr: dict, n: int = TOP) -> list:
    """The ``n`` longest single idle gaps, ``(seconds, label)``."""
    return sorted(_labels(tr), key=lambda x: -x[0])[:n]

