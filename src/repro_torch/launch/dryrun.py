"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace every
(arch x shape) cell on the production meshes and record per-device
argument bytes, memory, FLOPs and collectives.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single --layers 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape decode_32k --device cuda
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch.json

Where JAX compiles a cell for 256 or 512 fake devices, this process joins
a fake process group of 256 ranks (16 x 16) or 512 (2 x 16 x 16) as rank
0 (``torch.distributed``'s ``fake`` backend: collectives move nothing),
lays the step's arguments out on a ``DeviceMesh`` of ``--device``
(``lay_out``: parameters, optimizer state and batch as DTensors from
their logical specs, ``launch.mesh``; a decode cell's serve state by
``api.serve_state_on_mesh``, each rank's own planes) and runs the step
once.  Per cell this records:

  * ``arg_bytes_per_device``: JAX's arithmetic over the arguments' meta
    tensors (each dimension divided evenly by its mesh axes; a serve
    state's planes in their logical views);
  * ``memory``: ``MemTracker``'s peak for rank 0 by category (the
    parameters ``Parameter``; optimizer state, step, batch and serve state
    ``Other``; the step's tensors ``Activation``/``Temp``).  DTensor splits
    unevenly as ``torch.chunk`` does, so where an axis does not divide a
    dimension rank 0 holds the larger chunk and this exceeds the even
    split;
  * ``cost_analysis.flops``: rank 0's FLOPs (``analysis.comm``);
  * ``collectives``: rank 0's collectives (``analysis.comm``);
  * ``analytic``: ``analysis.analytic.cell_model`` at the same depth.

Where the record departs from JAX's: under ``--layers`` ``analytic`` is
the model at the cut depth (JAX's is at full depth); ``memory`` holds
MemTracker's categories (JAX has XLA's ``memory_analysis`` keys);
``trace_s`` stands in for ``lower_s``/``compile_s``; ``cost_analysis``
carries only ``flops``.

The local shards are meta tensors (shape and dtype, no storage), so the
step's own temporaries are meta too and a full-width cell needs no
memory.  Fake tensors would not do: under an active ``FakeTensorMode``
DTensor takes the run for compile tracing and drops its sharding cache
(the smoke llama3-8b step took 34.5 s against 11.1 s on the CPU, torch
2.13), and fake tensors outside an active mode leave the tensors the step
creates itself real, on the card.  A decode cell runs every kernel's
plain version (``kernel_impl="ref"``), which is what JAX's dry-run lowers
(its ``"auto"`` is the jnp reference off a TPU); the attention repeats on
the "model" ranks of a dp coordinate, as ``models.api`` says (JAX's KV
frames are replicated there too), and the expert plane's products split
over dp alone (``core.expertplane``), so their traced FLOPs exceed the
analytic model's even split.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs as cfgs
from ..analysis import analytic, comm
from ..core import expertplane, kvplane
from ..core.state import resolve_device
from ..models import api
from ..optim.optimizers import get_optimizer
from ..tree import leaves
from . import mesh as mesh_lib


def _mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or such a dict itself)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(shape: dict, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= _axis_size(shape, a)
        return n
    if ax == "dp":
        return shape.get("data", 1) * shape.get("pod", 1)
    if ax == "tp":
        return shape.get("model", 1)
    return shape.get(ax, 1)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def arg_bytes_per_device(struct_tree, spec_tree, mesh) -> dict:
    """Per-device bytes of an argument tree (meta tensors) under its
    logical specs, JAX's arithmetic: each tensor's bytes divided by the
    product of its spec's axis sizes.  ``host_tier`` separates far-tier
    slab buffers (a leaf path containing 'slab'), which live in host
    memory.  The entries of ``api.PerShard`` specs (a list of shard
    states, one a rank) divide by their axis too."""
    shape = _mesh_shape(mesh)
    total = {"device": 0.0, "host_tier": 0.0}

    def walk(struct, spec, path, div0):
        if isinstance(struct, torch.Tensor):
            div = div0
            if isinstance(spec, tuple):
                for ax in spec:
                    div *= _axis_size(shape, ax)
            b = struct.numel() * struct.dtype.itemsize / max(div, 1)
            total["host_tier" if "slab" in path else "device"] += b
            return
        if isinstance(spec, api.PerShard):
            div0 *= _axis_size(shape, spec.axis)
        if isinstance(struct, dict):
            for k in struct:
                sp = spec[k] if isinstance(spec, dict) else spec
                walk(struct[k], sp, path + "/" + str(k), div0)
            return
        if hasattr(struct, "_fields"):
            for k in struct._fields:
                sp = getattr(spec, k) if hasattr(spec, "_fields") else spec
                walk(getattr(struct, k), sp, path + "/" + k, div0)
            return
        if isinstance(struct, (tuple, list)):
            spc = spec if isinstance(spec, (tuple, list)) and \
                len(spec) == len(struct) and not _is_spec(spec) \
                else [spec] * len(struct)
            for i, s in enumerate(struct):
                walk(s, spc[i], path + f"/{i}", div0)

    walk(struct_tree, spec_tree, "", 1)
    return total


def _logical(x, cfg, shape, shards):
    """The serve state with each plane state in JAX's logical shapes
    (``view``: no trash rows, ``[B, NP]`` tables)."""
    if isinstance(x, kvplane.KVPlaneState):
        kvc, _ = api.kv_plan(cfg, shape, shards)
        return kvplane.KVPlaneState(**{k: x.view(kvc, k) for k in x._fields})
    if isinstance(x, expertplane.ExpertPlaneState):
        return expertplane.ExpertPlaneState(
            **{k: x.view(k) for k in x._fields})
    if isinstance(x, dict):
        return {k: _logical(v, cfg, shape, shards) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_logical(v, cfg, shape, shards) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_logical(v, cfg, shape, shards) for v in x)
    return x


def cell_config(arch: str, shape_name: str, layers_override=None):
    cfg = cfgs.get_config(arch)
    if layers_override:
        cfg = analytic.override_layers(cfg, layers_override)
    return cfg, cfgs.SHAPES[shape_name]


def _shards(shape, mesh) -> int:
    """The KV plane's shard count of a decode cell: the dp ranks for
    decode_long, else 1."""
    ms = _mesh_shape(mesh)
    return ms.get("pod", 1) * ms.get("data", 1) \
        if shape.kind == "decode_long" else 1


def build_cell(cfg, shape, mesh):
    """(fn, args, specs) of one cell: the step and its arguments as meta
    tensors with their logical spec trees; kimi trains with Adafactor, the
    others with AdamW.  ``mesh`` (a DeviceMesh or an {axis: size} dict)
    gives the shard count of decode_long."""
    bs = api.batch_specs(cfg, shape)
    batch = {k: v[0] for k, v in bs.items()}
    batch_spec = {k: v[1] for k, v in bs.items()}
    params = api.param_shapes(cfg)
    pspec = api.param_pspecs(cfg)

    if shape.kind == "train":
        opt_name = "adafactor" if cfg.name.startswith("kimi") else "adamw"
        opt = get_optimizer(opt_name)
        opt_state = opt.init(params)
        step = torch.zeros((), dtype=torch.int32, device="meta")
        return (api.make_train_step(cfg, opt),
                (params, opt_state, step, batch),
                (pspec, api.opt_state_pspecs(cfg, opt_name), None,
                 batch_spec))
    if shape.kind == "prefill":
        return (api.make_prefill_step(cfg), (params, batch),
                (pspec, batch_spec))

    shards = _shards(shape, mesh)
    state = _logical(api.init_decode_state(cfg, shape, shards=shards,
                                           device="meta"),
                     cfg, shape, shards)
    return (api.decode_step(cfg, shape, shards=shards, kernel_impl="ref"),
            (params, state, batch["tokens"]),
            (pspec, api.serve_state_pspecs(cfg, shape, shards),
             batch_spec["tokens"]))


def cell_arg_bytes(args, specs, mesh) -> dict:
    """The record's ``arg_bytes_per_device``: one entry per argument
    (``params``, ``arg1``, ...) and their ``total``, as JAX labels them."""
    out, acc = {}, {"device": 0.0, "host_tier": 0.0}
    for i, (st, sp) in enumerate(zip(args, specs)):
        ab = arg_bytes_per_device(st, sp, mesh)
        out["params" if i == 0 else "arg%d" % i] = ab
        acc["device"] += ab["device"]
        acc["host_tier"] += ab["host_tier"]
    out["total"] = acc
    return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives run, move nothing); the group is destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree) -> list:
    """Every tensor of a tree of dicts, lists, tuples and plane states
    (``None`` holds none)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif hasattr(tree, "_fields"):
        tree = [getattr(tree, k) for k in tree._fields]
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def lay_out(args, specs, mesh, kind: str, cfg=None, shape=None) -> list:
    """The step's arguments on ``mesh``: DTensors from their logical specs;
    a decode cell's serve state (``args[1]``, in its logical views) made
    anew as meta tensors and laid out as ``api.serve_state_on_mesh`` lays
    out a real one (``cfg`` and ``shape`` name the cell)."""
    if kind in ("train", "prefill"):
        return [mesh_lib.distribute_tree(a, mesh, s)
                for a, s in zip(args, specs)]
    if cfg is None or shape is None:
        raise ValueError(f"laying out a {kind} cell needs its cfg and shape")
    shards = _shards(shape, mesh)
    state = api.serve_state_on_mesh(
        cfg, shape, api.init_decode_state(cfg, shape, shards=shards,
                                          device="meta"), mesh, shards)
    return [mesh_lib.distribute_tree(args[0], mesh, specs[0]), state,
            mesh_lib.distribute(args[2], mesh, specs[2])]


def trace(fn, args, specs, mesh, kind: str, *, cfg=None, shape=None
          ) -> dict:
    """Run the step once on its arguments laid out on ``mesh``
    (``lay_out``: local shards on the meta device) under ``MemTracker``
    and a ``comm.TraceCounter``; returns the record's memory, FLOPs and
    collectives.  The parameters are tracked as ``Parameter``, the other
    arguments (optimizer state, step, batch, serve state) as external
    ``Other``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    dargs = lay_out(args, specs, mesh, kind, cfg, shape)
    holder = torch.nn.Module()
    for i, p in enumerate(leaves(dargs[0])):
        holder.register_parameter(f"p{i}", torch.nn.Parameter(
            p, requires_grad=False))
    mt = MemTracker()
    mt.track_external(holder, *[t for a in dargs[1:] for t in _tensors(a)])
    counter = comm.TraceCounter()
    with mesh_lib.use_mesh(mesh), implicit_replication(), mt, counter:
        fn(*dargs)
    peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]
    return {"memory": {getattr(k, "value", k): int(v)
                       for k, v in peak.items()},
            "cost_analysis": {"flops": float(counter.flops)},
            "collectives": comm.collective_summary(counter.records),
            "trace_s": round(time.time() - t0, 1)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             layers_override=None, device="cuda") -> dict:
    """One cell on the production mesh of ``mesh_kind`` ("single": 256
    ranks, "multi": 512), as rank 0 of a fake group.  A failure past the
    device check is recorded (``status: "fail"``) and the sweep goes on."""
    dev = resolve_device(device)
    world = 512 if mesh_kind == "multi" else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok"}
    t0 = time.time()
    with fake_world(world):
        mesh = mesh_lib.make_production_mesh(
            multi_pod=(mesh_kind == "multi"), device_type=dev.type)
        rec["mesh_shape"] = _mesh_shape(mesh)
        try:
            cfg, shape = cell_config(arch, shape_name, layers_override)
            fn, args, specs = build_cell(cfg, shape, mesh)
            rec["arg_bytes_per_device"] = cell_arg_bytes(args, specs, mesh)
            rec["analytic"] = analytic.cell_model(
                arch, shape_name, mesh_kind, layers_override or 0)
            rec.update(trace(fn, args, specs, mesh, shape.kind, cfg=cfg,
                             shape=shape))
        except Exception as e:  # noqa: BLE001 — record it, keep sweeping
            rec["status"] = "fail"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="single", choices=["single", "multi",
                                                        "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="results/dryrun_torch.json")
    p.add_argument("--layers", type=int, default=0,
                   help="override layer count (depth probes)")
    p.add_argument("--layout", default="2d", choices=["2d", "fsdp"],
                   help="logical sharding layout")
    p.add_argument("--device", default="cuda",
                   help="the mesh's device type (the traced shards are "
                        "meta tensors); cuda needs a card")
    args = p.parse_args()
    resolve_device(args.device)
    mesh_lib.set_layout(args.layout)

    todo = []
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        for a, sh, _ in cfgs.cells():
            for m in meshes:
                todo.append((a, sh, m))
    else:
        for m in meshes:
            todo.append((args.arch, args.shape, m))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok" and not args.layers}

    for a, sh, m in todo:
        if (a, sh, m) in done:
            print(f"[skip cached] {a} {sh} {m}", flush=True)
            continue
        print(f"[dryrun] {a} {sh} {m} ...", flush=True)
        rec = run_cell(a, sh, m, layers_override=args.layers or None,
                       device=args.device)
        print(f"  -> {rec['status']} trace={rec.get('trace_s')}s "
              f"flops/device={rec.get('cost_analysis', {}).get('flops')}",
              flush=True)
        if rec["status"] == "fail":
            print(rec["error"], flush=True)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"]) != (a, sh, m)]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    ok = sum(1 for r in results if r["status"] == "ok")
    print(f"[dryrun] {ok}/{len(results)} cells ok -> {args.out}")


if __name__ == "__main__":
    main()
