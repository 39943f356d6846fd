"""Host time of ``Engine.submit`` per tick (ms): the host clock around
each submit of the window, summed and divided by the ticks, outside the
traced segment."""


def read(rec):
    t = [s for s, _ in rec["ticks"]]
    return 1e3 * sum(t) / len(t) if t else None
