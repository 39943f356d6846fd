"""Host time of the execute's paging path a tick (ms): the union of the
program's ``engine.execute.paging`` spans (``batch._exec_paging``, run
every tick whether or not a page moves) over the traced segment's
ticks."""
from bench import spans


def read(rec):
    return spans.ms_per_tick(rec, "engine.execute.paging")
