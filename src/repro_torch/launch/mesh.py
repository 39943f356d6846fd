"""The ``far`` axis of the sharded plane over ``torch.distributed`` (the
port's counterpart of ``make_far_mesh``/``put_far`` in
``repro.launch.mesh``).

JAX lays a stacked ``[shards, ...]`` plane state out on a 1-D ``far`` mesh
and runs one per-shard program under ``shard_map``.  Here the far axis is
a process group with one rank per shard: NCCL with a card per rank, or
gloo on the CPU.  Every rank runs the same per-shard code on its own
shard (``core.shardplane``, ``core.kvplane.jitted_sharded_decode``) and
the collectives of the exchange go through the group: ``all_to_all`` and
``gather_shards`` below, the far axis's only collectives.  Only int32,
uint8 and the row dtype go on the wire; a bool crosses as uint8, because
gloo does not take bool everywhere.

Nothing here touches ``torch.distributed`` at import time, and nothing
reads a cluster from the environment: the caller names the rendezvous
(``tcp://localhost:<port>`` or ``file://<path>``), the world size and the
rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import state as st


def init_far(rank: int, world_size: int, init_method: str,
             device="cuda") -> torch.device:
    """Join the default process group as ``rank`` of ``world_size``:
    NCCL on card ``rank`` of this host, or gloo when ``device`` is the
    CPU.  Returns this rank's device."""
    dev = st.resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if rank >= n:
            raise ValueError(f"rank {rank} needs card {rank} but only {n} "
                             "are visible (NCCL takes one card a rank)")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def make_far_group(shards: int):
    """The process group of a ``shards``-wide far axis: the first
    ``shards`` ranks of the default group (all of them when they are
    ``shards``).  Like ``make_far_mesh`` it raises past the ranks there
    are."""
    if not dist.is_initialized():
        raise RuntimeError("make_far_group: no process group; call "
                           "init_far (or init_process_group) first")
    n = dist.get_world_size()
    if shards > n:
        raise ValueError(
            f"make_far_group(shards={shards}) needs {shards} ranks but the "
            f"process group has {n}; lower the shard count or start more "
            "ranks")
    if shards == n:
        return dist.group.WORLD
    return dist.new_group(list(range(shards)))


def far_device(group) -> torch.device:
    """This rank's device in ``group``: its card under NCCL, else the
    CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def put_far(states: list, group) -> list:
    """Lay a sharded state (a list of per-shard states, JAX's leading
    shard axis) out on the far axis: this rank keeps its own shard,
    ``states[rank]``, on its device; the entries of the other ranks'
    shards become ``None``."""
    S = dist.get_world_size(group)
    if len(states) != S:
        raise ValueError(f"{len(states)} shard states for a far axis of "
                         f"{S} ranks")
    me, dev = dist.get_rank(group), far_device(group)
    return [s.to(dev) if i == me else None for i, s in enumerate(states)]


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it goes on the wire: contiguous, a bool as uint8."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_to_all(group, x: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)`` over the far
    group: block j of ``x [S, ...]`` goes to rank j, and the result's
    block j came from rank j."""
    w = _wire(x)
    y = torch.empty_like(w)
    dist.all_to_all_single(y, w, group=group)
    return y.to(torch.bool) if x.dtype == torch.bool else y


def gather_shards(x: torch.Tensor, group) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` in rank order (the
    ``lax.all_gather`` of the mesh path, and how a host reads a sharded
    result whole)."""
    S = dist.get_world_size(group)
    w = _wire(x)
    y = torch.empty((S * w.numel(),), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(y, w.reshape(-1), group=group)
    y = y.view((S,) + tuple(x.shape))
    return y.to(torch.bool) if x.dtype == torch.bool else y
