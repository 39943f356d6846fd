"""The p99 of each request's wait from its arrival to the start of the
``submit`` that carries it (ms), outside the traced segment."""
import numpy as np


def read(rec):
    q = rec["queue_s"]
    if q is None:
        return None
    q = q[~np.isnan(q)]
    return float(np.percentile(q, 99)) * 1e3 if q.size else None
