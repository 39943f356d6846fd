"""The share of the traced segment's ticks whose plan and execute the
engine replayed from a captured CUDA graph (%): the program's
``engine.execute.replay`` intervals (one a replayed batch) over the
segment's ticks.  None where the trace has no such span (an engine that
dispatches eagerly, or the CPU)."""
from bench import spans


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["ticks"]:
        return None
    n = len(spans.intervals(seg["trace"], "engine.execute.replay"))
    return 100.0 * n / seg["ticks"] if n else None
