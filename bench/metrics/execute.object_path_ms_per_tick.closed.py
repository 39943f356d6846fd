"""Host time of the execute's object path a tick (ms): the union of the
program's ``engine.execute.runtime`` spans (``batch._exec_runtime``, which
every miss takes at a full tier) over the traced segment's ticks."""
from bench import spans


def read(rec):
    return spans.ms_per_tick(rec, "engine.execute.runtime")
