"""``misses / (hits + misses)`` (%) over the window, from the plane's
counters read at its two ends."""


def read(rec):
    s = rec["window_stats"]
    n = s["hits"] + s["misses"]
    return 100.0 * s["misses"] / n if n else None
