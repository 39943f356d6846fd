"""Host time of the plan a tick (ms): the union of the ``engine.plan``
spans (``Engine._plan``: classify, the paging plan with its prefetch and
victims, the object plan with its capacity governor) over the traced
segment's ticks."""
from bench import spans


def read(rec):
    return spans.ms_per_tick(rec, "engine.plan")
