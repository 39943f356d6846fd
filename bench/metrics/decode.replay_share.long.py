"""The share of the traced segment's decode steps that the program replayed
from a captured CUDA graph (%): the program's ``engine.decode.replay``
intervals (one a replayed step) over the segment's steps.  None where the
trace has no such span (a step that runs eagerly, or the CPU)."""
from bench import spans


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["steps"]:
        return None
    n = len(spans.intervals(seg["trace"], "engine.decode.replay"))
    return 100.0 * n / seg["steps"] if n else None
