"""The hybrid far-memory data plane (PyTorch port of ``repro.core``)."""
from .layout import (FREE, LOCAL, REMOTE, PSF_PAGING, PSF_RUNTIME,
                     PlaneConfig)
from .state import PlaneState, PlaneStats, create
from .plane import (access, update, evacuate, plan_evacuate,
                    execute_evacuate, advance_epoch, writeback_all,
                    evict_all, peek, occupancy, paging_fraction,
                    check_invariants)
from . import batch, faults, kvplane

__all__ = [
    "FREE", "LOCAL", "REMOTE", "PSF_PAGING", "PSF_RUNTIME", "PlaneConfig",
    "PlaneState", "PlaneStats", "create",
    "access", "update", "evacuate", "plan_evacuate", "execute_evacuate",
    "advance_epoch", "writeback_all", "evict_all",
    "peek", "occupancy", "paging_fraction", "check_invariants",
    "batch", "faults", "kvplane",
]
