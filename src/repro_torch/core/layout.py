"""Address layout for the Atlas hybrid data plane (PyTorch port).

Mirrors ``repro.core.layout``: every object (a tensor row) has a stable
virtual address ``vaddr = vpage * page_objs + slot`` recorded in the
smart-pointer table ``obj_loc``; a virtual page is backed either by a local
**frame** (the HBM tier) or by its dedicated **slab slot** (the far tier,
slab slot id == vpage id).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Backing kinds for a virtual page.
FREE = 0     # unallocated vpage (available to the log allocator)
LOCAL = 1    # backed by a frame (local / HBM tier)
REMOTE = 2   # backed by its slab slot (far tier)

# PSF values (1-bit path selector flag per vpage).
PSF_RUNTIME = False  # object-fetch ingress
PSF_PAGING = True    # paging ingress

# Bounds the epoch governor may move the adaptive CAR threshold within.
CAR_THR_MIN = 0.1
CAR_THR_MAX = 1.0


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """Static configuration of a plane instance (same fields and checks as
    the JAX ``PlaneConfig``; ``dtype`` is a torch dtype).

    ``kernel_impl``: ``"auto"`` launches the hand-written CUDA kernel for a
    CUDA tensor and the plain PyTorch version for a CPU tensor; ``"ref"``
    forces the plain version (explicit comparisons only)."""

    num_objs: int              # object-id capacity O
    obj_dim: int               # row width D (elements)
    page_objs: int             # objects per page P
    num_frames: int            # local frames F (the "local memory" budget)
    num_vpages: int            # virtual pages V (>= ceil(O/P) + log headroom)
    car_threshold: float = 0.8       # initial CAR >= threshold => PSF=paging
    evac_garbage_threshold: float = 0.5  # dead/allocated ratio triggering evacuation
    readahead: int = 0         # sequential prefetch window (pages per miss)
    dtype: Any = torch.float32
    prefetch: str = "sequential"     # "sequential" window | "majority" stride vote
    prefetch_budget: int = 8         # static cap on prefetch pages per batch
    car_decay: float = 0.5           # CAR EMA decay per epoch
    governor_gain: float = 0.05      # car_threshold step per epoch (adaptive)
    object_evict_batch: int = 8      # object-plane baseline knob
    lru_scan_budget: int = 0         # object-plane baseline knob
    psf_init_paging: bool = True     # pages start on the paging path
    access_mode: str = "batch"       # "batch" (vectorized) | "reference" (scalar oracle)
    kernel_impl: str = "auto"        # "auto" | "ref"
    faults: Any = None               # repro_torch.core.faults.Schedule or None

    def __post_init__(self):
        assert self.prefetch in ("sequential", "majority"), self.prefetch
        assert self.prefetch_budget >= 0
        assert self.num_vpages * self.page_objs >= self.num_objs, (
            "virtual page space must cover the object space")
        assert self.num_vpages >= self.data_pages + 4, (
            "need log headroom beyond the initial packing (fill pages)")
        assert self.num_frames >= 4, "need frames for fill pages + working set"
        assert self.kernel_impl in ("auto", "ref"), self.kernel_impl

    @property
    def data_pages(self) -> int:
        """Pages used by the initial dense packing of the object space."""
        return -(-self.num_objs // self.page_objs)

    @property
    def row_bytes(self) -> int:
        return self.obj_dim * self.dtype.itemsize

    @property
    def page_bytes(self) -> int:
        return self.page_objs * self.row_bytes


def vaddr_of(vpage, slot, page_objs: int):
    """The virtual address of ``slot`` on ``vpage``."""
    return vpage * page_objs + slot


def split_vaddr(vaddr, page_objs: int):
    """(vpage, slot) of a virtual address."""
    return vaddr // page_objs, vaddr % page_objs
