"""Device time of an evacuation round (ms): the operations that start
inside an ``engine.evacuate`` interval once the device has stood idle in
it (so all of them were launched by the round; all of the round's where
the device is idle at both of its ends), averaged over the rounds where
it does; None where none does."""
from bench import spans


def read(rec):
    return spans.device_ms_per_span(rec, "engine.evacuate")
