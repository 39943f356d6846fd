"""Named spans on the serving path, in ``torch.profiler``'s trace.

``span(name, tick)`` is a ``record_function`` range while a profiler is
recording, so the spans share the trace (and its clock) with the device
operations they launch; otherwise it is one shared no-op context, and a
span costs a module-level flag read.  The names are constant strings
under ``engine.``; ``tick`` (the engine's tick, recorded as the range's
argument) ties the spans of one batch together and is formatted only
while recording.

The tree (a child runs inside its parent):

- ``engine.submit``: ``engine.admit``, ``engine.plan``, ``engine.execute``,
  ``engine.evacuate``, ``engine.epoch``, ``engine.retire``
- ``engine.plan``: ``engine.plan.classify``, ``engine.plan.paging``,
  ``engine.plan.runtime``
- ``engine.execute``: ``engine.execute.begin``, ``.paging``, ``.runtime``,
  ``.profile``, ``.gather``; or, where the engine replays the batch's plan
  and execute from a captured CUDA graph, ``engine.execute.replay`` (the
  graph's launch) alone
- ``engine.evacuate``: ``engine.evacuate.plan``, ``engine.evacuate.page``
  (one a victim); or ``engine.evacuate.replay``
- ``engine.epoch``: ``engine.epoch.replay`` where the epoch is replayed
- ``engine.retire``: ``engine.wait``
- ``engine.decode.replay``, on its own (a decode step is no engine tick):
  the launch of a decode step's captured CUDA graph (``models/replay.py``)

A replayed call runs no Python inside its graph, so the spans of its
parts appear only on the calls that run eagerly or are captured.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

OFF = contextlib.nullcontext()


def span(name: str, tick: int | None = None):
    """A ``record_function`` range named ``name`` while a profiler records,
    else the shared no-op ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return torch.profiler.record_function(
        name, None if tick is None else str(tick))
