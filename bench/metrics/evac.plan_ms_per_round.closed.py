"""Host time of evacuation's plan a round (ms): the union of the
program's ``engine.evacuate.plan`` spans (``plane.plan_evacuate``) over
the number of ``engine.evacuate`` rounds in the traced segment."""
from bench import spans


def read(rec):
    return spans.ms_per_round(rec, "engine.evacuate.plan")
