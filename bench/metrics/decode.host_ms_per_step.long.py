"""Host time of a ``decode_step`` call (ms): the host clock around each
greedy step of the window (the step and its argmax), summed and divided
by the steps, outside the traced segment."""


def read(rec):
    t = rec["host_s"]
    return 1e3 * sum(t) / len(t) if t else None
