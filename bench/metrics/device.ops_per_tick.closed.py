"""Device operations (kernels, copies, fills) per tick in the traced
segment, from the profiler."""


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["ticks"]:
        return None
    n = len(seg["trace"]["device_ops"])
    return n / seg["ticks"] if n else None
