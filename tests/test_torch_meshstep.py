"""The train step laid out on a mesh (``launch.mesh``: parameters,
optimizer state and batch as DTensors from their logical specs, ``shard``
active) against the port's plain step, on four gloo ranks as a 2 x 2
``("data", "model")`` mesh.

The plain step is itself held to ``jax.value_and_grad`` by
``tests/test_torch_train.py``/``test_torch_optim.py``; JAX's own step on a
mesh fails on jax 0.9.0 (``src/repro/launch/mesh.py:158``), so it cannot
be the reference here.  Every rank draws the same smoke parameters and
batch (f32), runs the plain step on whole tensors and the mesh step on its
shards, and holds the loss, the gradient norm and every updated parameter
(gathered whole) within 1e-5 of the largest:

* llama3-8b in the ``"2d"`` and the ``"fsdp"`` layout, and its prefill
  step; a checkpoint of its parameters restored onto the mesh
  (``ckpt.restore(mesh=, spec_tree=)``) is the saved tree bit for bit, each
  leaf with its spec's placements;
* mixtral-8x7b (the dropping MoE) and seamless-m4t-medium (the
  encoder-decoder's cross attention), one spawn of their own.

A rank whose check fails exits non-zero; the parent then kills the others
and fails.  Each spawn has a hard limit of 120 s.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
WORLD = 4
TOL = 1e-5
CASES = {"llama": ["llama3-8b:train:2d", "llama3-8b:train:fsdp",
                   "llama3-8b:prefill:2d", "restore"],
         "families": ["mixtral-8x7b:train:2d",
                      "seamless-m4t-medium:train:2d"]}


def spawn(tmp_path: Path, cases: list) -> list:
    """Run this file as WORLD ranks over ``cases``; returns each rank's
    output.  Fails (after killing every rank) when a rank fails or the
    spawn outlives SPAWN_TIMEOUT_S."""
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    logs = [tmp_path / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r in range(WORLD):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), init, *cases],
                    stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT)))
        deadline = time.time() + SPAWN_TIMEOUT_S
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs):
                break
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad or time.time() > deadline:
                why = (f"rank {bad[0]} exited {rcs[bad[0]]}" if bad else
                       f"timed out after {SPAWN_TIMEOUT_S}s")
                tail = logs[bad[0] if bad else 0].read_text()[-4000:]
                pytest.fail(f"{WORLD}-rank spawn: {why}\n{tail}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [log.read_text() for log in logs]


@pytest.mark.parametrize("group", sorted(CASES))
def test_mesh_step_equals_plain_step(tmp_path, group):
    outs = spawn(tmp_path, CASES[group])
    for r, out in enumerate(outs):
        for case in CASES[group]:
            assert f"rank {r}: {case} ok" in out, out[-2000:]


# --------------------------------------------------------------------------
# the rank's side
# --------------------------------------------------------------------------

def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _close(got, want, what):
    got, want = _full(got).double(), want.double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    assert err <= TOL * max(top, 1e-30), (what, err, top)


def _batch(cfg, shape, api):
    rng = np.random.default_rng(5)
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if shape.kind == "train":
        labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
        labels[:, -1] = -1
        out["labels"] = labels
    specs = api.batch_specs(cfg, shape)
    for k in ("frames", "patches"):
        if k in specs:
            out[k] = rng.standard_normal(tuple(specs[k][0].shape)).astype(
                np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}, specs


def check_step(arch, kind, layout, mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import api
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import leaves, tree_map
    M.set_layout(layout)
    try:
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32)
        shape = configs.ShapeConfig("smoke", 32, 4, kind)
        params = api.init_params(cfg, seed=3, device="cpu")
        batch, specs = _batch(cfg, shape, api)
        dparams = M.distribute_tree(tree_map(torch.clone, params), mesh,
                                    api.param_pspecs(cfg))
        dbatch = {k: M.distribute(v, mesh, specs[k][1])
                  for k, v in batch.items()}
        if kind == "prefill":
            want = api.make_prefill_step(cfg)(params, batch)
            with M.use_mesh(mesh), implicit_replication():
                got = api.make_prefill_step(cfg)(dparams, dbatch)
            _close(got, want, "logits")
            return
        opt = get_optimizer("adafactor" if arch.startswith("kimi")
                            else "adamw")
        step = torch.full((), 10, dtype=torch.int32)   # lr > 0
        p1, _, _, loss1, g1 = api.make_train_step(cfg, opt)(
            params, opt.init(params), step, batch)
        with M.use_mesh(mesh), implicit_replication():
            p2, _, _, loss2, g2 = api.make_train_step(cfg, opt)(
                dparams, opt.init(dparams), M.distribute(step, mesh, None),
                dbatch)
        _close(loss2, loss1, "loss")
        _close(g2, g1, "gnorm")
        for i, (a, b) in enumerate(zip(leaves(p2), leaves(p1))):
            _close(a, b, f"param {i}")
    finally:
        M.set_layout("2d")


def check_restore(mesh, ckpt_dir: str):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import mesh as M
    from repro_torch.models import api
    from repro_torch.tree import flatten_with_path, leaves
    cfg = configs.get_smoke("llama3-8b")
    params = api.init_params(cfg, seed=4, device="cpu")
    specs = api.param_pspecs(cfg)
    if dist.get_rank() == 0:
        ckpt.save(ckpt_dir, 7, params)
    dist.barrier()
    got, _ = ckpt.restore(ckpt_dir, 7, params, mesh=mesh, spec_tree=specs)
    for (path, g), w in zip(flatten_with_path(got), leaves(params)):
        spec = specs
        for k in path:
            spec = spec[k]
        assert isinstance(g, DTensor), path
        assert list(g.placements) == M.placements(mesh, spec), path
        assert torch.equal(g.full_tensor(), w), path


def _rank_main(rank: int, init: str, cases: list) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_far(rank, WORLD, init, device="cpu")
    try:
        mesh = M.make_host_mesh(2, 2, device_type="cpu")
        for case in cases:
            if case == "restore":   # beside the rendezvous file
                check_restore(mesh, str(Path(init[len("file://"):]).parent
                                        / "ckpt"))
            else:
                check_step(*case.split(":"), mesh)
            print(f"rank {rank}: {case} ok", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3:])
