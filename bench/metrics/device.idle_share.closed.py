"""The device's idle share (%) of the pipelined run: ``1 - busy / wall``
a tick, busy being the union of the device's operations a tick in the
traced segment and wall the window's time a tick before the segment
(the profiler's own host work slows the traced ticks, so their wall
would overstate the idle share)."""


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["ticks"]:
        return None
    wall_s, ticks = seg["before"]
    if ticks <= 0 or wall_s <= 0:
        return None
    busy = seg["trace"]["busy_s"] / seg["ticks"]
    return 100.0 * (1.0 - busy / (wall_s / ticks))
