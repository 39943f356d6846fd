"""The device's idle share (%) of the decode loop: ``1 - busy / wall`` a
step, busy being the union of the device's operations a step in the
traced segment and wall the window's time a step before the segment (the
profiler's own host work slows the traced steps, so their wall would
overstate the idle share).  None where the trace holds no device
operation (a CPU run)."""


def read(rec):
    seg = rec["segment"]
    if not seg or not seg["trace"] or not seg["trace"]["device_ops"] \
            or not seg["steps"]:
        return None
    wall_s, steps = seg["before"]
    if steps <= 0 or wall_s <= 0:
        return None
    busy = seg["trace"]["busy_s"] / seg["steps"]
    return 100.0 * (1.0 - busy / (wall_s / steps))
