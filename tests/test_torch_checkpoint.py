"""The port's checkpointing, orchestrator and training launcher
(``repro_torch.checkpoint.ckpt``, ``runtime.orchestrator``,
``launch.train``) against the JAX package: the counterparts of
tests/test_checkpoint_runtime.py, checkpoints read across the two packages
bit for bit, the orchestrator's losses against JAX's across an injected
failure (within 1e-5 relative), and the launcher's failure drill on the
CPU.  The elastic restore onto a new mesh (JAX's
``test_elastic_restore_new_mesh``) waits for the port's model-mesh layout
helpers: the port refuses it, and a test holds that."""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.checkpoint import ckpt as jckpt
from repro.models import api as japi
from repro.optim import get_optimizer as jget
from repro.optim import optimizers as jopt
from repro.runtime import orchestrator as jorch
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.data.synthetic import DataConfig, batch_for_step
from repro_torch.launch import train as ttrain
from repro_torch.optim import get_optimizer
from repro_torch.optim import optimizers as topt
from repro_torch.runtime.orchestrator import (FailureInjector, Orchestrator,
                                              OrchestratorConfig)
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def tree_eq(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        np.allclose(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,)), "step": torch.tensor(7)}}
    ckpt.save(str(tmp_path), 3, tree, extra={"next_step": 3})
    assert ckpt.latest(str(tmp_path)) == 3
    got, extra = ckpt.restore(str(tmp_path), 3, tree, device=CPU)
    assert tree_eq(tree, got)
    assert got["nested"]["step"].dtype == torch.int64
    assert extra["next_step"] == 3


def test_atomic_publish_never_partial(tmp_path):
    tree = {"w": torch.ones((4,))}
    ckpt.save(str(tmp_path), 1, tree)
    # a stale tmp dir from a crashed writer must not count as a checkpoint
    os.makedirs(tmp_path / "step_2.tmp")
    assert ckpt.latest(str(tmp_path)) == 1


def test_restore_onto_a_mesh_is_refused(tmp_path):
    """JAX's elastic re-mesh restore waits for the port's model-mesh
    layout helpers: the port says so instead of ignoring the mesh."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(str(tmp_path), 5, tree)
    with pytest.raises(NotImplementedError, match="mesh"):
        ckpt.restore(str(tmp_path), 5, tree, device=CPU, mesh=object(),
                     spec_tree={"w": ("dp", "tp")})


def test_prune(tmp_path):
    tree = {"w": torch.ones(2)}
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), s, tree)
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.latest(str(tmp_path)) == 5
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [4, 5]


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = {"w": torch.ones((64, 64))}
    saver.save(10, tree)
    saver.wait()
    assert ckpt.latest(str(tmp_path)) == 10


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """A step that updates the state in place right after ``save`` returns
    must not reach the checkpoint (``.cpu()`` of a CPU tensor is the same
    storage: the snapshot copies)."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    w = torch.zeros((256, 256))
    saver.save(1, {"w": w})
    w.add_(1.0)
    saver.wait()
    got, _ = ckpt.restore(str(tmp_path), 1, {"w": w}, device=CPU)
    assert float(got["w"].abs().max()) == 0.0


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------

def _flat_model_state(rng):
    """A (params, opt_state, step) tuple of a flat model (no layer list),
    the same structure in both packages."""
    params = {"embed": rng.randn(8, 4).astype(np.float32),
              "head": {"w": rng.randn(4, 8).astype(np.float32),
                       "b": rng.randn(8).astype(np.float32)}}
    opt = {"mu": {k: v for k, v in params.items()},
           "nu": {"embed": np.abs(params["embed"]),
                  "head": {"w": params["head"]["w"] ** 2,
                           "b": params["head"]["b"] ** 2}}}
    return (params, opt, np.asarray(11, np.int32))


def _files(d):
    return sorted(os.listdir(d))


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rng = np.random.RandomState(0)
    state = _flat_model_state(rng)
    jstate = jax.tree.map(jnp.asarray, state)
    jckpt.save(str(tmp_path / "j"), 4, jstate, extra={"next_step": 4})
    template = tree_map(torch.from_numpy, state)
    got, extra = ckpt.restore(str(tmp_path / "j"), 4, template, device=CPU)
    assert extra == {"next_step": 4}
    assert got[2].dtype == torch.int32 and int(got[2]) == 11
    for a, b in zip(leaves(got), jax.tree.leaves(state)):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and the port writes the same files, manifest included
    ckpt.save(str(tmp_path / "t"), 4, template, extra={"next_step": 4})
    assert _files(tmp_path / "j" / "step_4") == _files(tmp_path / "t" /
                                                       "step_4")
    for f in _files(tmp_path / "j" / "step_4"):
        assert (tmp_path / "j" / "step_4" / f).read_bytes() == (
            tmp_path / "t" / "step_4" / f).read_bytes(), f


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    rng = np.random.RandomState(1)
    state = _flat_model_state(rng)
    tstate = tree_map(torch.from_numpy, state)
    ckpt.save(str(tmp_path), 7, tstate, extra={"next_step": 7})
    assert jckpt.latest(str(tmp_path)) == 7
    got, extra = jckpt.restore(str(tmp_path), 7,
                               jax.tree.map(jnp.asarray, state))
    assert extra == {"next_step": 7}
    assert got[2].dtype == jnp.int32
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_leaf_written_as_jax_writes_it(tmp_path):
    """numpy has no bf16: JAX's leaf lands on disk as raw ``<V2`` bits with
    ``bfloat16`` in the manifest; the port writes the same bytes and reads
    either back as the same bf16 tensor."""
    x = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    jckpt.save(str(tmp_path / "j"), 0, {"w": jnp.asarray(x, jnp.bfloat16)})
    t = torch.from_numpy(x).to(torch.bfloat16)
    ckpt.save(str(tmp_path / "t"), 0, {"w": t})
    for f in _files(tmp_path / "j" / "step_0"):
        assert (tmp_path / "j" / "step_0" / f).read_bytes() == (
            tmp_path / "t" / "step_0" / f).read_bytes(), f
    got, _ = ckpt.restore(str(tmp_path / "j"), 0, {"w": t}, device=CPU)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)


def test_model_checkpoint_names_follow_jax(tmp_path):
    """A checkpoint of (params, opt_state, step) of a model: the port's
    leaves carry JAX's names with a layer index where JAX stacks the
    layers; ``convert`` bridges the two layouts."""
    cfg = tcfgs.get_smoke("llama3-8b").scaled(dtype=torch.float32)
    from repro_torch.models import api as tapi
    params = tapi.init_params(cfg, seed=0, device=CPU)
    opt = get_optimizer("adamw")
    state = (params, opt.init(params), torch.zeros((), dtype=torch.int32))
    ckpt.save(str(tmp_path), 0, state)
    names = [f.split("_", 1)[1] for f in _files(tmp_path / "step_0")
             if f.endswith(".npy")]
    assert "0_blocks_1_attn_wq.npy" in names
    assert "1_mu_embed.npy" in names and names[-1] == "2.npy"
    got, _ = ckpt.restore(str(tmp_path), 0, state, device=CPU)
    assert tree_eq(got, state)


# --------------------------------------------------------------------------
# the orchestrator
# --------------------------------------------------------------------------

def _toy_problem():
    """state = (params, step counter): two leaves, so restore covers both.
    Returns new tensors, as JAX's jitted step does."""
    def train_step(state, batch):
        w, n = state
        grad = 2 * (w - batch)          # d/dw (w - b)^2
        w = w - 0.1 * grad
        return (w, n + 1), {"loss": torch.mean((w - batch) ** 2)}
    return train_step


def _toy_in_place():
    """The same problem updating its state in place, as the port's
    optimizers do."""
    def train_step(state, batch):
        w, n = state
        w.sub_(0.1 * 2 * (w - batch))
        n.add_(1)
        return state, {}
    return train_step


@pytest.mark.parametrize("step_fn", [_toy_problem, _toy_in_place],
                         ids=["new", "in_place"])
def test_orchestrator_failure_recovery(tmp_path, step_fn):
    target = torch.full((4,), 3.0)
    inj = FailureInjector(fail_at_steps=[7, 13])
    orch = Orchestrator(
        OrchestratorConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
        step_fn(), lambda step: target, injector=inj)
    init = (torch.zeros((4,)), torch.zeros((4,)))
    state = orch.run(init, num_steps=40)
    assert orch.metrics["restarts"] == 2
    assert inj.failures == 2
    assert float((state[0] - 3.0).abs().max()) < 0.1
    assert float(init[0].abs().max()) == 0.0     # the caller's state kept
    assert int(state[1][0]) == 40


@pytest.mark.parametrize("step_fn", [_toy_problem, _toy_in_place],
                         ids=["new", "in_place"])
def test_orchestrator_resume_determinism(tmp_path, step_fn):
    """Run A: 20 uninterrupted steps.  Run B: killed at 9, resumed.  The
    final state must match exactly (step-indexed data)."""
    batch_fn = lambda step: torch.full((4,), float(step % 5))
    orch_a = Orchestrator(OrchestratorConfig(ckpt_dir=str(tmp_path / "a"),
                                             ckpt_every=5),
                          step_fn(), batch_fn)
    sa = orch_a.run((torch.zeros(4), torch.zeros(4)), 20)
    inj = FailureInjector(fail_at_steps=[9])
    orch_b = Orchestrator(OrchestratorConfig(ckpt_dir=str(tmp_path / "b"),
                                             ckpt_every=5),
                          step_fn(), batch_fn, injector=inj)
    sb = orch_b.run((torch.zeros(4), torch.zeros(4)), 20)
    assert orch_b.metrics["restarts"] == 1
    assert torch.equal(sa[0], sb[0])


def test_straggler_accounting(tmp_path):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(0.25)            # one straggler step
        return state, {}

    orch = Orchestrator(OrchestratorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=100,
                                           straggler_factor=5.0),
                        step_fn, lambda s: torch.zeros(1))
    orch.run((torch.zeros(1),), num_steps=12)
    assert orch.metrics["stragglers"] >= 1


def test_failure_injector_over_a_fault_schedule():
    from repro_torch.core import faults
    inj = FailureInjector([3], schedule=faults.Schedule(fail_at=(1,)))
    for step in range(5):
        if step in (1, 3):
            with pytest.raises(RuntimeError, match=f"step {step}"):
                inj.check(step)
        inj.check(step)                 # each step fires once
    assert inj.failures == 2


def test_orchestrator_reproduces_jax_losses_across_a_failure(tmp_path):
    """llama3-8b's smoke config from JAX's initial parameters, AdamW, 24
    steps of ``batch_for_step`` with a checkpoint every 8 and a failure at
    step 11, through each package's orchestrator: the port's loss at every
    step (each re-run step too) within 1e-5 relative of JAX's."""
    jcfg = jcfgs.get_smoke("llama3-8b").scaled(dtype=jnp.float32)
    tcfg = tcfgs.get_smoke("llama3-8b").scaled(dtype=torch.float32)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), device=CPU)
    dcfg = DataConfig(vocab=tcfg.vocab, seq_len=32, global_batch=2)
    batch_fn = lambda step: batch_for_step(dcfg, step)

    from repro.launch import train as jtrain
    jo = jget("adamw", lr=jopt.cosine_schedule(3e-4, 20, 24))
    jstep = jtrain.build(jcfg, jo)
    jlosses = []

    def jlog(state, batch):
        state, m = jstep(state, batch)
        jlosses.append((int(state[2]) - 1, float(m["loss"])))
        return state, m

    jorch.Orchestrator(
        jorch.OrchestratorConfig(ckpt_dir=str(tmp_path / "j"), ckpt_every=8),
        jlog, batch_fn, injector=jorch.FailureInjector([11])).run(
        (jp, jo.init(jp), jnp.zeros((), jnp.int32)), 24)

    to = get_optimizer("adamw", lr=topt.cosine_schedule(3e-4, 20, 24))
    tstep = ttrain.build(tcfg, to)
    tlosses = []

    def tlog(state, batch):
        state, m = tstep(state, batch)
        tlosses.append((int(state[2]) - 1, float(m["loss"])))
        return state, m

    orch = Orchestrator(OrchestratorConfig(ckpt_dir=str(tmp_path / "t"),
                                           ckpt_every=8),
                        tlog, batch_fn, injector=FailureInjector([11]))
    orch.run((tp, to.init(tp), torch.zeros((), dtype=torch.int32)), 24)
    assert orch.metrics["restarts"] == 1
    steps = [s for s, _ in tlosses]
    assert steps == list(range(11)) + list(range(8, 24))
    assert steps == [s for s, _ in jlosses]
    for (s, lt), (_, lj) in zip(tlosses, jlosses):
        np.testing.assert_allclose(lt, lj, rtol=1e-5, err_msg=f"step {s}")


def test_train_launcher_failure_drill(tmp_path):
    """As tests/test_launchers.py drills JAX's launcher: a failure at step
    11 of 24 recovers and the run finishes, on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--smoke", "--steps", "24", "--batch", "2", "--seq",
         "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "8",
         "--fail-at", "11", "--log-every", "8", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restarts=1" in out.stdout, out.stdout
    assert "loss" in out.stdout
    assert ckpt.latest(str(tmp_path)) == 24
