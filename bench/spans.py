"""What the readers of the program's spans share.  A span's time is the
union of the intervals of every span of that name in the traced segment,
so a span nested in one of its own name (the harness's ``engine.plan``
around the program's) counts once.  A device operation is attributed to
a span by its start alone (the reduction keeps no correlation ids): one
stream runs in order, so an operation that starts inside the span after
the device has stood idle in it was launched inside it, and where the
device is idle when the span opens and when it closes, those are all of
its launches."""
from __future__ import annotations

import bisect


def intervals(tr: dict, name: str) -> list:
    """The union of the ``name`` spans' intervals ``[start, end]`` (us),
    in order."""
    out = []
    for s, e in sorted((s, s + d) for n, s, d in tr["spans"] if n == name):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def total_us(tr: dict, name: str) -> float | None:
    """The union's length (us); None where the trace has no such span."""
    iv = intervals(tr, name)
    return sum(e - s for s, e in iv) if iv else None


def _trace(rec: dict):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["ticks"]:
        return None, 0
    return seg["trace"], seg["ticks"]


def ms_per_tick(rec: dict, name: str) -> float | None:
    """The ``name`` spans' union over the segment's ticks (ms)."""
    tr, ticks = _trace(rec)
    t = total_us(tr, name) if tr else None
    return None if t is None else t * 1e-3 / ticks


def _first_idle(gaps: list, a: float) -> float | None:
    """The first moment at or after ``a`` that falls in one of the
    reduction's idle gaps (sorted ``(start, end)`` pairs, us); None where
    none does."""
    j = bisect.bisect_right(gaps, (a, float("inf"))) - 1
    if j >= 0 and gaps[j][1] >= a:
        return a
    return gaps[j + 1][0] if j + 1 < len(gaps) else None


def device_ms_per_span(rec: dict, name: str) -> float | None:
    """Device time (ms) of the operations that start inside a ``name``
    interval once the device has stood idle in it (at its opening, or at
    the end of the busy run that its opening found), averaged over the
    intervals where it does; None where none does, or where the trace
    holds no device operation (a CPU run).  Every operation counted was
    launched inside the interval; the interval's own operations that
    queued behind a busy run at its opening, or started after it closed,
    are missed."""
    tr, _ = _trace(rec)
    if not tr or not tr["device_ops"]:
        return None
    gaps = [tuple(g) for g in tr["gaps"]]
    ops = sorted((s, d) for _, s, d in tr["device_ops"])
    starts = [s for s, _ in ops]
    found, t = 0, 0.0
    for a, b in intervals(tr, name):
        g = _first_idle(gaps, a)
        if g is None or g > b:
            continue
        i, j = bisect.bisect_left(starts, g), bisect.bisect_right(starts, b)
        found += 1
        t += sum(d for _, d in ops[i:j])
    return t * 1e-3 / found if found else None
