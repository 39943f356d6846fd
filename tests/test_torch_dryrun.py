"""The port's dry-run (``repro_torch.launch.dryrun``) and its cost models
(``repro_torch.analysis``) against the JAX package.

* ``analytic.cell_model`` equals JAX's (parameters, FLOPs, HBM bytes,
  collective bytes per chip) for every cell on both meshes; only the rates
  differ (the H100's);
* ``arg_bytes_per_device`` equals JAX's for every cell on both meshes
  (16 x 16 and 2 x 16 x 16), to a relative 1e-12.  JAX's side runs in one
  subprocess: importing ``repro.launch.dryrun`` forces 512 host devices,
  which this process must not see;
* a smoke train cell traced on a fake 8-rank (4, 2) mesh: FLOPs, gradient
  sync collectives, per-rank FLOPs x 8 against the unsharded step's, and
  ``MemTracker``'s parameter bytes against the argument bytes;
* every arch's smoke train, prefill, decode and (outside LONG_SKIP)
  decode_long cells trace on that mesh, the long cells with the sparse
  combine's all-gathers over dp, llama3-8b's decode cell at a rank's share
  of the plain step's FLOPs;
* a full-width decode cell traces ``ok`` with its argument bytes and the
  analytic model; ``--device cuda`` with no card raises.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jcfgs
from repro.analysis import analytic as janalytic
from repro_torch import configs as tcfgs
from repro_torch.analysis import analytic, comm
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
MODEL_KEYS = ("params_total", "params_active", "chips", "flops_per_chip",
              "hbm_bytes_per_chip", "collective_bytes_per_chip",
              "model_flops_global")

JAX_ARG_BYTES = r"""
import json
from repro.launch import dryrun as jd   # forces 512 host devices first
import jax
from repro import configs as cfgs
devs = jax.devices()
meshes = {"single": jax.make_mesh((16, 16), ("data", "model"),
                                  devices=devs[:256]),
          "multi": jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                                 devices=devs)}
out = {}
for arch, shape, _ in cfgs.cells():
    for kind, mesh in meshes.items():
        _, args, _, _, specs = jd.build_cell(arch, shape, mesh)
        out[f"{arch}|{shape}|{kind}"] = [
            jd.arg_bytes_per_device(st, sp, mesh)
            for st, sp in zip(args, specs)]
print(json.dumps(out))
"""


def test_analytic_matches_jax_for_every_cell():
    assert jcfgs.cells() == tcfgs.cells()
    for arch, shape, _ in tcfgs.cells():
        for kind in MESHES:
            got = analytic.cell_model(arch, shape, kind)
            want = janalytic.cell_model(arch, shape, kind)
            for k in MODEL_KEYS:
                assert got[k] == want[k], (arch, shape, kind, k)
            assert got["t_compute_s"] == got["flops_per_chip"] / 989.4e12


def test_arg_bytes_match_jax_for_every_cell():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_ARG_BYTES], env=env,
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    n = 0
    for arch, sname, _ in tcfgs.cells():
        for kind, mesh in MESHES.items():
            cfg, shape = dryrun.cell_config(arch, sname)
            _, args, specs = dryrun.build_cell(cfg, shape, mesh)
            for got, exp in zip((dryrun.arg_bytes_per_device(a, s, mesh)
                                 for a, s in zip(args, specs)),
                                want[f"{arch}|{sname}|{kind}"]):
                for k in ("device", "host_tier"):
                    assert abs(got[k] - exp[k]) <= 1e-12 * max(exp[k], 1), \
                        (arch, sname, kind, k, got[k], exp[k])
                n += 1
    assert n == sum(4 if s == "train_4k" else 2 if s == "prefill_32k"
                    else 3 for _, s, _ in tcfgs.cells()) * 2


def _smoke(arch):
    cfg = tcfgs.get_smoke(arch)
    if arch == "llama3-8b":   # the JAX smoke dry-run's cut
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    return cfg


def test_smoke_train_cell_on_a_fake_mesh():
    cfg = _smoke("llama3-8b")
    shape = tcfgs.ShapeConfig("smoke", 64, 8, "train")
    with dryrun.fake_world(8):
        mesh = tmesh.make_host_mesh(4, 2, device_type="cpu")
        fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
        ab = dryrun.cell_arg_bytes(args, specs, mesh)
        rec = dryrun.trace(fn, args, specs, mesh, "train")
        plain = comm.TraceCounter()
        with plain:
            fn(*args)
    flops = rec["cost_analysis"]["flops"]
    assert flops > 0 and plain.flops > 0
    assert abs(flops * 8 - plain.flops) <= 0.05 * plain.flops, \
        (flops * 8, plain.flops)
    coll = rec["collectives"]
    # gradient sync: the replicas' partial gradients reduced over "data"
    assert coll["all-reduce"]["count"] + coll["reduce-scatter"]["count"] > 0
    assert coll["total_wire_bytes_corrected"] > 0
    assert rec["memory"]["Parameter"] == ab["params"]["device"]
    assert plain.records == []


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_every_smoke_train_and_prefill_cell_traces(arch):
    cfg = _smoke(arch)
    with dryrun.fake_world(8):
        mesh = tmesh.make_host_mesh(4, 2, device_type="cpu")
        for kind in ("train", "prefill"):
            shape = tcfgs.ShapeConfig("smoke", 64, 8, kind)
            fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
            rec = dryrun.trace(fn, args, specs, mesh, kind)
            assert rec["cost_analysis"]["flops"] > 0, (arch, kind)
            assert rec["memory"]["Total"] > 0, (arch, kind)


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_every_smoke_decode_cell_traces(arch, monkeypatch):
    """Each arch's smoke decode cell, and its decode_long cell unless the
    arch is in LONG_SKIP, traced on a fake 8-rank (4, 2) mesh: FLOPs and
    memory; a sparse long cell's combine all-gathers acc, m and l over dp
    (4 ranks) once each per plane call; llama3-8b's dense cell computes a
    rank's share of the batch (rank 0's FLOPs between the plain step's / 8
    and / 4, within 5%)."""
    cfg = _smoke(arch)
    calls = []
    real = tmesh.all_gather

    def spy(x, mesh, logical="dp"):
        calls.append((tuple(x.shape), x.dtype, logical))
        return real(x, mesh, logical)
    monkeypatch.setattr(tmesh, "all_gather", spy)
    kinds = ["decode"] + ([] if arch in tcfgs.LONG_SKIP else ["decode_long"])
    with dryrun.fake_world(8):
        mesh = tmesh.make_host_mesh(4, 2, device_type="cpu")
        for kind in kinds:
            shape = tcfgs.ShapeConfig("smoke", 64 if kind == "decode"
                                      else 1024, 8 if kind == "decode"
                                      else 1, kind)
            calls.clear()
            fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
            rec = dryrun.trace(fn, args, specs, mesh, kind, cfg=cfg,
                               shape=shape)
            flops = rec["cost_analysis"]["flops"]
            assert flops > 0, (arch, kind)
            assert rec["memory"]["Total"] > 0, (arch, kind)
            _, mode = api.kv_plan(cfg, shape, 4)
            if mode != "sparse":
                assert calls == [], (arch, kind)
                continue
            H, Dh = cfg.n_heads, cfg.hd
            n_calls = (6 if cfg.family == "hybrid" else cfg.n_layers)
            assert calls == [((1, H, Dh), torch.float32, "dp"),
                             ((1, H, 1), torch.float32, "dp"),
                             ((1, H, 1), torch.float32, "dp")] * n_calls
            sizes = {4 * H * Dh * 4, 4 * H * 4}
            seen = [r for r in comm_records(fn, args, specs, mesh, kind,
                                            cfg, shape)
                    if r["kind"] == "all-gather" and r["group"] == 4
                    and r["out_bytes"] in sizes]
            assert len(seen) == 3 * n_calls, (arch, len(seen))
            assert rec["collectives"]["all-gather"]["count"] >= len(seen)
        if arch == "llama3-8b":
            shape = tcfgs.ShapeConfig("smoke", 64, 8, "decode")
            fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
            rank = dryrun.trace(fn, args, specs, mesh, "decode", cfg=cfg,
                                shape=shape)["cost_analysis"]["flops"]
            plain = comm.TraceCounter()
            with plain:
                fn(args[0], api.init_decode_state(cfg, shape,
                                                  device="meta"), args[2])
            assert plain.records == []
            assert plain.flops / 8 * 0.95 <= rank <= plain.flops / 4 * 1.05, \
                (rank, plain.flops)


def test_kimi_decode_splits_the_expert_products_over_dp(monkeypatch):
    """kimi-k2's smoke decode cell traced on a fake 8-rank (4, 2) mesh: as
    XLA splits JAX's expert einsums along the hot store's layout (d_model
    over dp), a rank's expert products (every ``_bmm_f32`` of the expert
    plane) take the plain step's FLOPs over dp = 4, within 5%, and no
    all-gather brings a rank the hot store (``[S, d, F]`` of
    ``hot_wi``/``hot_wg``/``hot_wo``): their partial sums are all-reduced
    over dp instead, twice a layer.  (d_ff 40: at the smoke config's 32
    the hot store's bytes are those of the embedding table's gather.)"""
    from torch.utils.flop_counter import bmm_flop
    from repro_torch.core import expertplane
    cfg = dataclasses.replace(_smoke("kimi-k2-1t-a32b"), d_ff=40)
    shape = tcfgs.ShapeConfig("smoke", 64, 8, "decode")
    flops = []
    real = expertplane._bmm_f32

    def spy(a, b):
        flops.append(bmm_flop(a.shape, b.shape))
        return real(a, b)
    monkeypatch.setattr(expertplane, "_bmm_f32", spy)
    with dryrun.fake_world(8):
        mesh = tmesh.make_host_mesh(4, 2, device_type="cpu")
        fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
        fn(args[0], api.init_decode_state(cfg, shape, device="meta"),
           args[2])
        plain = sum(flops)
        flops.clear()
        records = comm_records(fn, args, specs, mesh, "decode", cfg, shape)
    rank = sum(flops)
    assert plain > 0 and len(flops) == 3 * cfg.n_layers
    assert abs(rank * 4 - plain) <= 0.05 * plain, (rank, plain)
    epc = api._expert_cfg(cfg)
    hot = epc.hot_slots * cfg.d_model * cfg.d_ff * epc.dtype.itemsize
    gathers = [r for r in records if r["kind"] == "all-gather"]
    assert not [r for r in gathers if r["out_bytes"] == hot], gathers
    partial = epc.hot_slots * 8 * cfg.d_ff * 4   # [S, C, F] f32
    assert len([r for r in records if r["kind"] == "all-reduce"
                and r["group"] == 4 and r["out_bytes"] == partial]) \
        == 2 * cfg.n_layers, records


def comm_records(fn, args, specs, mesh, kind, cfg, shape) -> list:
    """The collectives a traced step issues, each as ``TraceCounter``
    records it."""
    from torch.distributed.tensor.experimental import implicit_replication
    dargs = dryrun.lay_out(args, specs, mesh, kind, cfg, shape)
    counter = comm.TraceCounter()
    with tmesh.use_mesh(mesh), implicit_replication(), counter:
        fn(*dargs)
    return counter.records


def test_moe_groups_split_over_the_batch_axes_that_divide_them():
    """mixtral's dropping MoE on a fake (pod 2, data 16, model 1) mesh with
    32 sequences: its 16 token groups (``gcd(32, 16)``) do not split over
    the 32 batch ranks, so they split over "data" alone
    (``mesh.dividing_axes``) and the train and decode cells trace, as the
    2 x 16 x 16 cells at 256 and 128 sequences do."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = dataclasses.replace(_smoke("mixtral-8x7b"), n_layers=1)
    with dryrun.fake_world(32):
        mesh = init_device_mesh("cpu", (2, 16, 1),
                                mesh_dim_names=("pod", "data", "model"))
        assert tmesh.dividing_axes(mesh, "batch", 32) == "batch"
        assert tmesh.dividing_axes(mesh, "batch", 16) == "data"
        assert tmesh.dividing_axes(mesh, "batch", 1) is None
        for kind in ("train", "decode"):
            shape = tcfgs.ShapeConfig("smoke", 16, 32, kind)
            fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
            rec = dryrun.trace(fn, args, specs, mesh, kind, cfg=cfg,
                               shape=shape)
            assert rec["cost_analysis"]["flops"] > 0, kind


def test_decode_cell_records_its_bytes_and_the_missing_trace():
    """A decode cell at full width, 2 layers, on the 16 x 16 mesh records
    its argument bytes (which JAX's arithmetic fixes, see
    test_arg_bytes_match_jax_for_every_cell) and the analytic model, and
    the trace that used to be missing: ``ok``, with FLOPs, collectives and
    the serve state in MemTracker's ``Other``."""
    rec = dryrun.run_cell("llama3-8b", "decode_32k", "single",
                          layers_override=2, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh_shape"] == MESHES["single"]
    assert rec["arg_bytes_per_device"]["total"]["device"] > 0
    assert rec["analytic"] == analytic.cell_model("llama3-8b", "decode_32k",
                                                  "single", 2)
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["memory"]["Other"] > 0          # the serve state, external
    assert rec["collectives"]["total_wire_bytes_corrected"] > 0


def test_dryrun_wants_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("llama3-8b", "train_4k", "single", layers_override=2,
                        device="cuda")
