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
* every arch's smoke train and prefill cells trace on that mesh;
* a decode cell records its argument bytes, the analytic model and its
  trace's ``NotImplementedError``; ``--device cuda`` with no card raises.
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


def test_decode_cell_records_its_bytes_and_the_missing_trace():
    rec = dryrun.run_cell("llama3-8b", "decode_32k", "single",
                          layers_override=2, device="cpu")
    assert rec["status"] == "fail"
    assert rec["error"].startswith("NotImplementedError"), rec["error"]
    assert "Queue 1 item 6" in rec["error"]
    assert rec["mesh_shape"] == MESHES["single"]
    assert rec["arg_bytes_per_device"]["total"]["device"] > 0
    assert rec["analytic"] == analytic.cell_model("llama3-8b", "decode_32k",
                                                  "single", 2)


def test_dryrun_wants_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal shows only without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("llama3-8b", "train_4k", "single", layers_override=2,
                        device="cuda")
