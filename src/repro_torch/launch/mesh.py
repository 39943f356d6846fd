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

The model-mesh layout (the port of ``make_production_mesh``,
``make_host_mesh``, ``resolve``, ``sharding_tree`` and ``constrain``)
lays parameters, optimizer state and batches out as DTensors over a
``DeviceMesh`` of the default process group, from the same logical specs
as JAX:

  * ``"dp"`` -- data/FSDP; ``("pod", "data")`` when the mesh has a pod
    axis, else ``("data",)``; under the ``"fsdp"`` layout ``"model"`` too.
  * ``"tp"`` -- tensor parallel, ``"model"`` (nothing under ``"fsdp"``).
  * ``"batch"`` -- the data-parallel batch axis, never ``"model"``.

A tensor dimension split over several mesh axes becomes ``Shard(i)`` on
each of them, in mesh order, which is JAX's major-to-minor order; the
mesh axes no dimension names are ``Replicate()``.  DTensor splits a
dimension that the axis does not divide as ``torch.chunk`` does (the first
ranks hold one more row), where JAX pads.  ``with use_mesh(mesh):`` makes
``mesh`` current, as JAX's ``with mesh:`` does, and ``constrain`` (the
models' ``shard``) redistributes a DTensor to its spec on it.
"""
from __future__ import annotations

import contextlib
import math

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


# --------------------------------------------------------------------------
# the model mesh: logical specs over a DeviceMesh
# --------------------------------------------------------------------------

def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("the model mesh needs a process group; call "
                           "init_far (or init_process_group) first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """A ``DeviceMesh`` shaped from the default group's world size, by
    JAX's rule: the model axis gets ``gcd(n, 16)`` ranks, data parallelism
    the rest; with ``multi_pod`` a pod axis of 2 is split off first when
    the count allows it (256 ranks: 16 x 16; 512 with ``multi_pod``: 2 x
    16 x 16)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    if multi_pod:
        pods = 2 if n % 2 == 0 and n >= 2 else 1
        per_pod = n // pods
        model = math.gcd(per_pod, 16)
        return init_device_mesh(device_type, (pods, per_pod // model, model),
                                mesh_dim_names=("pod", "data", "model"))
    model = math.gcd(n, 16)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, device_type="cuda"):
    """A small ``(data, model)`` mesh over the first ``data * model`` ranks
    (tests, examples); raises past the ranks there are."""
    from torch.distributed.device_mesh import DeviceMesh
    n = _world()
    if data * model > n:
        raise ValueError(
            f"make_host_mesh(data={data}, model={model}) needs "
            f"{data * model} ranks but the process group has {n}; lower the "
            "mesh size or start more ranks (a fake process group of N ranks "
            "traces without them)")
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


# "2d" (default): FSDP over (pod, data) x TP over model; "fsdp": pure
# ZeRO-3 over every mesh axis, no tensor parallelism
_LAYOUT = "2d"


def set_layout(name: str):
    global _LAYOUT
    if name not in ("2d", "fsdp"):
        raise ValueError(f"layout {name!r}: '2d' or 'fsdp'")
    _LAYOUT = name


def get_layout() -> str:
    return _LAYOUT


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _axis(mesh, logical):
    if logical is None:
        return None
    names = _names(mesh)
    if logical == "batch":
        return ("pod", "data") if "pod" in names else ("data",)
    if logical == "dp":
        axes = ("pod", "data") if "pod" in names else ("data",)
        if _LAYOUT == "fsdp":
            axes = axes + ("model",)
        return axes
    if logical == "tp":
        return None if _LAYOUT == "fsdp" else "model"
    return logical


def resolve(mesh, spec) -> tuple:
    """A logical spec -> one entry per tensor dimension (``None``, a mesh
    axis name or a tuple of them), JAX's ``PartitionSpec`` entries (a
    one-axis tuple is its axis)."""
    if spec is None:
        return ()
    out = (_axis(mesh, ax) for ax in spec)
    return tuple(r[0] if isinstance(r, tuple) and len(r) == 1 else r
                 for r in out)


def placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh
    dimension, ``Shard(i)`` where tensor dimension ``i`` is split over it,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(resolve(mesh, spec)):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's "
                             f"major-to-minor order {names}")
        for j in at:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[j]!r} "
                                 "splits two dimensions")
            out[j] = Shard(i)
    return out


def is_spec(s) -> bool:
    """A logical spec leaf: a plain tuple of axis entries (str / None /
    tuple of str); NamedTuples (state containers) are not leaves."""
    if s is None:
        return True
    if not isinstance(s, tuple) or hasattr(s, "_fields"):
        return False
    return all(e is None or isinstance(e, str)
               or (isinstance(e, tuple) and all(isinstance(x, str) for x in e))
               for e in s)


def map_specs(fn, tree):
    """``fn`` of each spec of a spec tree (dicts, lists, tuples and state
    containers with ``_fields`` holding specs)."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(**{k: map_specs(fn, getattr(tree, k))
                             for k in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree)}")


def resolve_tree(mesh, spec_tree):
    return map_specs(lambda s: resolve(mesh, s), spec_tree)


def sharding_tree(mesh, spec_tree):
    """The spec tree with each spec replaced by its placement list."""
    return map_specs(lambda s: placements(mesh, s), spec_tree)


def distribute(x: torch.Tensor, mesh, spec):
    """``x`` (the whole tensor, on every rank) laid out on ``mesh`` by
    ``spec``: each rank keeps its own chunk, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(mesh, spec),
                             src_data_rank=None)


def distribute_tree(tree, mesh, spec_tree):
    """Every leaf of ``tree`` laid out by the spec at its place in
    ``spec_tree`` (a spec tree of the same structure, one spec a leaf)."""
    from ..tree import flatten_with_path, unflatten
    flat = flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        spec = spec_tree
        for k in path:
            spec = getattr(spec, k) if hasattr(spec, "_fields") else spec[k]
        out.append(distribute(leaf, mesh, spec))
    return unflatten(tree, out)


_CURRENT = []
_RULES = []


def _register_rules() -> None:
    """Sharding rules for three ops DTensor has none for: ``index_add``
    (the dropping MoE's expert counts) and ``scatter_reduce`` (its segment
    starts) run replicated or split along a dimension they do not index;
    ``log_sigmoid_backward`` (xLSTM's gates) is elementwise."""
    if _RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    R = Replicate()

    @register_sharding(aten.index_add.default)
    def index_add_rule(x, dim, index, source, alpha=1):
        # index is 1-D along ``dim``: split the other dimensions only
        return [([R], [R, None, R, R])] + [
            ([Shard(d)], [Shard(d), None, R, Shard(d)])
            for d in range(x.ndim) if d != dim % x.ndim]

    @register_sharding(aten.scatter_reduce.two)
    def scatter_reduce_rule(x, dim, index, src, reduce, include_self=True):
        return [([R], [R, None, R, R, None, None])] + [
            ([Shard(d)], [Shard(d), None, Shard(d), Shard(d), None, None])
            for d in range(x.ndim) if d != dim % x.ndim]

    @register_sharding(aten.log_sigmoid_backward.default)
    def log_sigmoid_backward_rule(grad, x, buffer):
        # the buffer is x's shape on the CPU and empty on the card
        full = tuple(buffer.shape) == tuple(x.shape)
        return [([R], [R, R, R])] + [
            ([Shard(d)], [Shard(d), Shard(d), Shard(d) if full else R])
            for d in range(x.ndim)]

    _RULES.append(True)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh for ``constrain`` (JAX's ``with
    mesh:``)."""
    _register_rules()
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


def gather_dp(w):
    """A DTensor weight with the dimensions it splits over the ``dp`` mesh
    axes gathered (FSDP's all-gather before use, which XLA's partitioner
    makes on its own): a product with it then runs on this rank's batch
    shard, and its gradient comes back reduce-scattered.  The identity for
    a plain tensor or with no current mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = current_mesh()
    if mesh is None or not isinstance(w, DTensor):
        return w
    dp = _axis(mesh, "dp")
    pl = [Replicate() if name in dp else p
          for name, p in zip(_names(w.device_mesh), w.placements)]
    return w if pl == list(w.placements) else w.redistribute(
        w.device_mesh, pl)


def local(fn, in_specs, out_spec):
    """``fn`` run on each rank's own shards (JAX's ``shard_map``, DTensor's
    ``local_map``): on the current mesh its DTensor arguments are laid out
    by ``in_specs`` first and its result is a DTensor laid out by
    ``out_spec``; with no current mesh, or plain arguments, ``fn``
    itself."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    def run(*xs):
        mesh = current_mesh()
        if mesh is None or not any(isinstance(x, DTensor) for x in xs):
            return fn(*xs)
        return local_map(
            fn, out_placements=placements(mesh, out_spec),
            in_placements=tuple(placements(mesh, s) for s in in_specs),
            device_mesh=mesh, redistribute_inputs=True)(*xs)
    return run


def axis_size(mesh, logical) -> int:
    """The number of ranks a logical axis (``"dp"``, ``"tp"``,
    ``"batch"``) splits over on ``mesh``."""
    shape = dict(zip(_names(mesh), mesh.shape))
    axes = _axis(mesh, logical) or ()
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= shape[a]
    return n


def axis_mesh(mesh, logical="dp"):
    """The mesh axes a logical axis splits over as one 1-D ``DeviceMesh``
    (several axes flattened in major-to-minor order, ``("pod", "data")`` on
    the multi-pod mesh), or ``None`` when it names no axis.  Its local
    rank is this rank's coordinate on the logical axis, the index of its
    chunk of a dimension split over it."""
    axes = _axis(mesh, logical)
    if not axes:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]
    return sub if len(axes) == 1 else sub._flatten()


def coordinate(mesh, logical="dp") -> tuple[int, int]:
    """(this rank's coordinate, the number of ranks) on a logical axis."""
    sub = axis_mesh(mesh, logical)
    return (0, 1) if sub is None else (sub.get_local_rank(), sub.size())


def all_gather(x: torch.Tensor, mesh, logical="dp") -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` on a logical axis of ``mesh``
    in its coordinate order (``lax.all_gather``), through the functional
    collective, which the dry-run's ``analysis.comm.TraceCounter`` counts.
    A bool crosses as uint8."""
    sub = axis_mesh(mesh, logical)
    if sub is None:
        return x[None]
    c10d = torch.ops._c10d_functional
    y = c10d.wait_tensor(c10d.all_gather_into_tensor(
        _wire(x)[None], sub.size(), sub.get_group().group_name))
    return y.to(torch.bool) if x.dtype == torch.bool else y


def all_reduce(x: torch.Tensor, mesh, logical="dp") -> torch.Tensor:
    """``x`` summed over a logical axis of ``mesh`` (``lax.psum``), through
    the functional collective, which the dry-run's
    ``analysis.comm.TraceCounter`` counts; ``x`` itself when the axis
    names no mesh axis."""
    sub = axis_mesh(mesh, logical)
    if sub is None:
        return x
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(
        x.contiguous(), "sum", sub.get_group().group_name))


def dividing_axes(mesh, logical, n: int):
    """A spec entry for a dimension of ``n`` split over a logical axis:
    the logical axis when its ranks divide ``n``, else its minor-most mesh
    axes whose ranks do (``"data"`` of ``("pod", "data")``), else ``None``
    (whole on every rank)."""
    shape = dict(zip(_names(mesh), mesh.shape))
    axes = _axis(mesh, logical) or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if n % math.prod(shape[a] for a in axes) == 0:
        return logical
    while axes and n % math.prod(shape[a] for a in axes):
        axes = axes[1:]
    return (axes[0] if len(axes) == 1 else axes) if axes else None


def split_heads(x, heads: int):
    """x [..., heads * dh] -> [..., heads, dh].  On a current mesh whose
    axis splits x's last dimension into a count of parts that does not
    divide ``heads`` (llama3-8b's 8 kv heads over 16 "model" ranks), that
    dimension is gathered over the axis first: DTensor cannot split a
    dimension it shards unevenly into heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if current_mesh() is not None and isinstance(x, DTensor):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1
              and heads % x.device_mesh.size(j) else p
              for j, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(tuple(x.shape[:-1]) + (heads, x.shape[-1] // heads))


def reduce_partial(y):
    """A DTensor product's partial sums all-reduced (``Partial`` ->
    ``Replicate``), where XLA's partitioner all-reduces a tensor-parallel
    product's output; otherwise ``y`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if current_mesh() is None or not isinstance(y, DTensor) or not any(
            isinstance(p, Partial) for p in y.placements):
        return y
    return y.redistribute(y.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in y.placements])


def constrain(x, spec):
    """Logical sharding constraint: ``x`` redistributed to ``spec`` on the
    current mesh when ``x`` is a DTensor; the identity for a plain tensor or
    with no current mesh."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(mesh, spec))
