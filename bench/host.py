"""What the host did, read the same way by every runner: the process's
CPU seconds, page faults and context switches (``getrusage``), and the
machine's steal seconds where the system reports them."""
from __future__ import annotations

import os
import resource
import time


def steal_s() -> float:
    """The machine's steal time so far (s); NaN where not reported."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def usage() -> dict:
    """The process's CPU seconds, faults and context switches so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": time.process_time(), "minor_faults": ru.ru_minflt,
            "major_faults": ru.ru_majflt,
            "voluntary_switches": ru.ru_nvcsw,
            "involuntary_switches": ru.ru_nivcsw}
