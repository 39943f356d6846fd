"""Plane state and constructors (PyTorch port of ``repro.core.state``).

The JAX plane is functional: every operation returns a new state, and a
scatter at an out-of-bounds index (the "sentinel" ``V``, ``F`` or ``O``) is
dropped.  This port updates its tensors in place (the far-tier slab of a
full-size plane is gigabytes and is never copied per call), and every
scatter-target tensor carries ONE extra trailing "trash" row along its
first axis: a sentinel index lands there instead of being dropped.  So
``slab`` is ``[V+1, P, D]``, ``frames`` ``[F+1, P, D]``, ``obj_loc``
``[O+1]`` and so on.  The trash rows hold garbage and are never read:
whole-vector reads slice ``[:V]``/``[:F]``/``[:O]``, and
``repro_torch.convert`` strips them.  ``PlaneState.view`` gives the
logical (unpadded) tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .layout import FREE, REMOTE, PlaneConfig

# the padded fields and their first-axis extent ("V", "F" or "O", plus one
# trash row); every other field is an unpadded 0-d scalar
PADDED = {
    "frames": "F", "slab": "V", "backing": "V", "frame_of": "V",
    "vpage_of": "F", "obj_loc": "O", "obj_of": "V", "live_count": "V",
    "alloc_count": "V", "cat": "V", "psf": "V", "access": "V",
    "car_ema": "V", "prefetched": "V", "pin": "V", "dirty": "V",
    "clock": "V", "obj_last": "O",
}


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; asking for CUDA on a machine without it is an error."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but no CUDA device is "
            "available (pass device='cpu' to run the plain versions)")
    return dev


@dataclasses.dataclass(eq=False)
class PlaneStats:
    """Event counters (0-d int32 tensors), same fields and order as JAX."""

    hits: torch.Tensor
    misses: torch.Tensor
    page_ins: torch.Tensor
    obj_ins: torch.Tensor
    page_outs: torch.Tensor
    dirty_page_outs: torch.Tensor
    psf_to_paging: torch.Tensor
    psf_to_runtime: torch.Tensor
    evac_moved: torch.Tensor
    evac_pages: torch.Tensor
    obj_outs: torch.Tensor
    lru_scans: torch.Tensor
    prefetch_issued: torch.Tensor
    prefetch_used: torch.Tensor
    epochs: torch.Tensor
    ingress_spills: torch.Tensor
    fetch_failures: torch.Tensor
    egress_failures: torch.Tensor

    _fields = ()  # filled below

    @classmethod
    def zeros(cls, device) -> "PlaneStats":
        return cls(*[torch.zeros((), dtype=torch.int32, device=device)
                     for _ in cls._fields])

    def _asdict(self) -> dict:
        return {k: getattr(self, k) for k in self._fields}


PlaneStats._fields = tuple(f.name for f in dataclasses.fields(PlaneStats))


@dataclasses.dataclass(eq=False)
class PlaneState:
    """State of the hybrid data plane; field order and dtypes as JAX
    (int8 ``backing``, int32 tables, bool bit tables, f32 governor state).
    Padded fields carry the trash row described in the module docstring."""

    frames: torch.Tensor      # [F+1, P, D] local tier ("HBM")
    slab: torch.Tensor        # [V+1, P, D] far tier (slot id == vpage id)
    backing: torch.Tensor     # [V+1] int8  FREE / LOCAL / REMOTE
    frame_of: torch.Tensor    # [V+1] int32 frame id when LOCAL else -1
    vpage_of: torch.Tensor    # [F+1] int32 inverse map, -1 = free frame
    obj_loc: torch.Tensor     # [O+1] int32 vaddr, -1 = unallocated
    obj_of: torch.Tensor      # [V+1, P] int32 occupant object id, -1 = empty
    live_count: torch.Tensor  # [V+1] int32 live slots
    alloc_count: torch.Tensor # [V+1] int32 slots ever allocated (log cursor)
    cat: torch.Tensor         # [V+1, P] bool card access table
    psf: torch.Tensor         # [V+1] bool path selector flag (True = paging)
    access: torch.Tensor      # [V+1, P] bool access bit since last evacuation
    car_ema: torch.Tensor     # [V+1] f32 decayed CAR
    car_thr: torch.Tensor     # [] f32 adaptive PSF threshold
    epoch: torch.Tensor       # [] int32
    epoch_page_ins: torch.Tensor  # [] int32
    epoch_obj_ins: torch.Tensor   # [] int32
    prefetched: torch.Tensor  # [V+1] bool prefetched, not yet demand-touched
    pin: torch.Tensor         # [V+1] int32 deref counts
    dirty: torch.Tensor       # [V+1] bool modified since last writeback
    clock: torch.Tensor       # [V+1] int32 last-touch step
    fill_vpage: torch.Tensor      # [] int32 ingress fill page (-1 = none)
    evac_hot_vpage: torch.Tensor  # [] int32
    evac_cold_vpage: torch.Tensor # [] int32
    remote_fill_vpage: torch.Tensor  # [] int32
    step: torch.Tensor            # [] int32 logical time
    obj_last: torch.Tensor    # [O+1] int32 per-object last access
    lru_hand: torch.Tensor    # [] int32
    stats: PlaneStats

    _fields = ()  # filled below

    @property
    def device(self) -> torch.device:
        return self.slab.device

    def view(self, name: str) -> torch.Tensor:
        """The logical (trash-row-free) tensor of field ``name``."""
        x = getattr(self, name)
        return x[:-1] if name in PADDED else x

    def clone(self) -> "PlaneState":
        """Deep copy (the plane mutates in place; oracles compare copies)."""
        kw = {k: getattr(self, k).clone() for k in self._fields
              if k != "stats"}
        kw["stats"] = PlaneStats(**{k: v.clone() for k, v in
                                    self.stats._asdict().items()})
        return PlaneState(**kw)

    def to(self, device) -> "PlaneState":
        """This state on ``device`` (itself if it is there already)."""
        dev = torch.device(device)
        kw = {k: getattr(self, k).to(dev) for k in self._fields
              if k != "stats"}
        kw["stats"] = PlaneStats(**{k: v.to(dev) for k, v in
                                    self.stats._asdict().items()})
        return PlaneState(**kw)


PlaneState._fields = tuple(f.name for f in dataclasses.fields(PlaneState))


def create(cfg: PlaneConfig, initial, device="cuda") -> PlaneState:
    """Build a plane holding ``initial`` ([num_objs, obj_dim]) entirely in the
    far tier, densely packed into the first ``data_pages`` vpages."""
    dev = resolve_device(device)
    O, D = cfg.num_objs, cfg.obj_dim
    V, P, F = cfg.num_vpages, cfg.page_objs, cfg.num_frames
    initial = torch.as_tensor(initial)
    if tuple(initial.shape) != (O, D):
        raise ValueError(f"initial rows have shape {tuple(initial.shape)}, "
                         f"the plane holds {(O, D)}")
    i32 = dict(dtype=torch.int32, device=dev)

    dp = cfg.data_pages
    pad = dp * P - O
    slab = torch.zeros((V + 1, P, D), dtype=cfg.dtype, device=dev)
    slab[:dp].view(dp * P, D)[:O].copy_(initial.to(dev, cfg.dtype))

    obj_of = torch.full((V + 1, P), -1, **i32)
    obj_of[:dp].view(-1)[:O] = torch.arange(O, **i32)

    counts = np.zeros((V + 1,), np.int32)
    counts[:dp] = P
    if pad:
        counts[dp - 1] = P - pad
    counts = torch.from_numpy(counts).to(dev)

    backing = torch.full((V + 1,), FREE, dtype=torch.int8, device=dev)
    backing[:dp] = REMOTE

    def scalar(x, dtype=torch.int32):
        return torch.full((), x, dtype=dtype, device=dev)

    obj_loc = torch.arange(O + 1, **i32)
    obj_loc[O] = -1
    return PlaneState(
        frames=torch.zeros((F + 1, P, D), dtype=cfg.dtype, device=dev),
        slab=slab,
        backing=backing,
        frame_of=torch.full((V + 1,), -1, **i32),
        vpage_of=torch.full((F + 1,), -1, **i32),
        obj_loc=obj_loc,
        obj_of=obj_of,
        live_count=counts,
        alloc_count=counts.clone(),
        cat=torch.zeros((V + 1, P), dtype=torch.bool, device=dev),
        psf=torch.full((V + 1,), bool(cfg.psf_init_paging), dtype=torch.bool,
                       device=dev),
        access=torch.zeros((V + 1, P), dtype=torch.bool, device=dev),
        car_ema=torch.zeros((V + 1,), dtype=torch.float32, device=dev),
        car_thr=scalar(cfg.car_threshold, torch.float32),
        epoch=scalar(0),
        epoch_page_ins=scalar(0),
        epoch_obj_ins=scalar(0),
        prefetched=torch.zeros((V + 1,), dtype=torch.bool, device=dev),
        pin=torch.zeros((V + 1,), **i32),
        dirty=torch.zeros((V + 1,), dtype=torch.bool, device=dev),
        clock=torch.zeros((V + 1,), **i32),
        fill_vpage=scalar(-1),
        evac_hot_vpage=scalar(-1),
        evac_cold_vpage=scalar(-1),
        remote_fill_vpage=scalar(-1),
        step=scalar(0),
        obj_last=torch.zeros((O + 1,), **i32),
        lru_hand=scalar(0),
        stats=PlaneStats.zeros(dev),
    )


def create_sharded(cfg: PlaneConfig, shards: int, initial,
                   device="cuda") -> list:
    """The sharded plane as a list of ``shards`` per-shard states (JAX's
    leading shard axis): shard ``s`` owns global objects ``[s*O, (s+1)*O)``
    (``O = cfg.num_objs``, the PER-SHARD capacity) with its own slab
    partition, frame pool, profiling state and governor threshold.
    ``initial`` is the GLOBAL ``[shards*O, D]`` array, split contiguously;
    each shard's slab is its own copy."""
    O, D = cfg.num_objs, cfg.obj_dim
    initial = torch.as_tensor(initial)
    if tuple(initial.shape) != (shards * O, D):
        raise ValueError(f"initial rows have shape {tuple(initial.shape)}, "
                         f"{shards} shards hold {(shards * O, D)}")
    return [create(cfg, initial[i * O:(i + 1) * O], device)
            for i in range(shards)]


def shard_slice(states: list, i: int) -> PlaneState:
    """One shard's plane from a sharded state."""
    return states[i]


def bump(stats: PlaneStats, **deltas) -> PlaneStats:
    """Increment named counters (int32, on the counters' device)."""
    for k, v in deltas.items():
        setattr(stats, k, (getattr(stats, k) + v).to(torch.int32))
    return stats
