"""Host time blocked on the device a tick (ms): the union of the
program's ``engine.wait`` spans (``Engine._wait_ready``, under
``engine.retire``) over the traced segment's ticks."""
from bench import spans


def read(rec):
    return spans.ms_per_tick(rec, "engine.wait")
