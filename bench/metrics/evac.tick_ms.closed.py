"""Median host time (ms) of the closed loop's ticks whose ``submit`` ran a
foreground evacuation (every ``evac_every`` ticks, known from the
engine's configuration), outside the traced segment."""
import statistics


def read(rec):
    t = [s for s, evac in rec["ticks"] if evac]
    return 1e3 * statistics.median(t) if t else None
