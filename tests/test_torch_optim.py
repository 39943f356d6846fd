"""The port's optimizers, train step, gradient accumulation, compression,
schedules and step-indexed data (``repro_torch.optim``, ``models.api.
make_train_step``, ``data.synthetic``, ``data.pipeline``) against the JAX
package.

Parameters are drawn in JAX and carried into the port
(``convert.params_from_numpy``); updated parameters and optimizer state
come back with ``convert.params_to_numpy``/``opt_state_to_numpy``.  In f32,
after each step: the loss within 1e-5 relative, gnorm within 1e-5 relative
(the port sums the squares of per-layer leaves where JAX sums stacked
ones), every updated parameter and state leaf within 1e-4 of its largest
|value|.  Schedules within 4 ulp (the cosine from two math libraries);
quantized gradients bit for bit, their scale and residual within 1 ulp;
data bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.optim import accumulated_value_and_grad as j_accum
from repro.optim import compression as jcomp
from repro.optim import get_optimizer as jget
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.data import synthetic as tsyn
from repro_torch.data.pipeline import Prefetcher
from repro_torch.launch.train import frontend_inputs
from repro_torch.models import api as tapi
from repro_torch.optim import (Adafactor, AdamW, accumulated_value_and_grad,
                               compression, get_optimizer)
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.tree import tree_map, value_and_grad

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
ULP = float(np.finfo(np.float32).eps)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    top = float(np.abs(want).max(initial=0.0))
    assert err <= tol * max(top, 1e-30), (what, err, top)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _close_trees(got, want, tol, what):
    g = dict(_leaves(got))
    w = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert g.keys() == w.keys(), (what, sorted(g), sorted(w))
    for name in w:
        _close(g[name], w[name], tol, f"{what} {name}")


# --------------------------------------------------------------------------
# the train step against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,opt_name", [("llama3-8b", "adamw"),
                                           ("kimi-k2-1t-a32b", "adafactor"),
                                           ("seamless-m4t-medium", "adamw")])
def test_train_step_matches_jax(arch, opt_name):
    """Three ``make_train_step`` steps from JAX's initial parameters over
    ``batch_for_step``'s batches: loss, gnorm, the updated parameters and
    the optimizer state against JAX's after every step.  Adafactor's
    factored statistics and update clipping reach across JAX's stacked
    layer axis."""
    jcfg = jcfgs.get_smoke(arch).scaled(dtype=jnp.float32)
    tcfg = tcfgs.get_smoke(arch).scaled(dtype=torch.float32)
    jo = jget(opt_name, lr=jopt.cosine_schedule(1e-2, 1, 10))
    to = get_optimizer(opt_name, lr=topt.cosine_schedule(1e-2, 1, 10))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    _close_trees(convert.opt_state_to_numpy(tcfg, ts), js, 0.0, "init")
    jstep, tstep = jnp.zeros((), jnp.int32), torch.zeros((), dtype=torch.int32)
    jfn = jax.jit(japi.make_train_step(jcfg, jo))
    tfn = tapi.make_train_step(tcfg, to)
    dcfg = tsyn.DataConfig(vocab=tcfg.vocab, seq_len=24, global_batch=2)
    for i in range(3):
        b = tsyn.batch_for_step(dcfg, i,
                                frontend=frontend_inputs(tcfg, 24) or None)
        jp, js, jstep, jl, jg = jfn(jp, js, jstep,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tstep, tl, tg = tfn(tp, ts, tstep,
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert int(tstep) == int(jstep) == i + 1
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tg), float(jg), rtol=LOSS_RTOL)
        _close_trees(convert.params_to_numpy(tcfg, tp), jp, PARAM_TOL,
                     f"{arch} step {i} params")
        _close_trees(convert.opt_state_to_numpy(tcfg, ts), js, PARAM_TOL,
                     f"{arch} step {i} {opt_name} state")


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_update_matches_jax_on_nested_stacks(opt_name):
    """Three updates of zamba2's smoke parameter tree (a group's nested
    [6, 5, ...] Mamba2 stacks, the shared block, the [2, ...] tail) with
    seeded gradients, against JAX's update of the stacked tree: every
    parameter and state leaf within 1e-5 of its largest |value|, gnorm
    within 1e-5 relative.  (A whole zamba2 train step is not compared:
    its 38 layers move JAX's own gradients by 3.3e-4 of the largest under
    one ulp of parameter noise, and Adafactor scales a row of small
    gradients up to a full step.)"""
    jcfg = jcfgs.get_smoke("zamba2-1.2b").scaled(dtype=jnp.float32)
    tcfg = tcfgs.get_smoke("zamba2-1.2b").scaled(dtype=torch.float32)
    jo = jget(opt_name, lr=jopt.cosine_schedule(1e-2, 0, 10))
    to = get_optimizer(opt_name, lr=topt.cosine_schedule(1e-2, 0, 10))
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.RandomState(4)
    for i in range(3):
        g = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.01).astype(
            np.float32), jax.device_get(jp))
        jp, js, jg = jax.jit(jo.update)(jax.tree.map(jnp.asarray, g), js, jp,
                                        jnp.asarray(i, jnp.int32))
        tp, ts, tg = to.update(convert.params_from_numpy(tcfg, g, "cpu"),
                               ts, tp, torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-5)
        _close_trees(convert.params_to_numpy(tcfg, tp), jp, 1e-5,
                     f"step {i} params")
        _close_trees(convert.opt_state_to_numpy(tcfg, ts), js, 1e-5,
                     f"step {i} {opt_name} state")


def test_opt_state_carries_across():
    """``opt_state_from_numpy`` of ``opt_state_to_numpy`` is the same
    state, for both optimizers."""
    cfg = tcfgs.get_smoke("zamba2-1.2b").scaled(dtype=torch.float32)
    params = tapi.init_params(cfg, seed=1, device="cpu")
    for opt in (AdamW(), Adafactor()):
        st = tree_map(lambda x: x + torch.rand(x.shape), opt.init(params))
        back = convert.opt_state_from_numpy(
            cfg, convert.opt_state_to_numpy(cfg, st), device="cpu")
        a, b = (dict(_leaves(convert.opt_state_to_numpy(cfg, x)))
                for x in (st, back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_training_reduces_loss():
    """The counterpart of tests/test_system.py::test_training_reduces_loss
    in the port."""
    cfg = tcfgs.ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                           dtype=torch.float32, remat=False)
    params = tapi.init_params(cfg, seed=0, device="cpu")
    opt = get_optimizer("adamw", lr=lambda s: 1e-3)
    opt_state = opt.init(params)
    step_fn = tapi.make_train_step(cfg, opt)
    toks = torch.arange(16, dtype=torch.int32).tile(4, 4)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    step = torch.zeros((), dtype=torch.int32)
    losses = []
    for _ in range(30):
        params, opt_state, step, loss, gnorm = step_fn(params, opt_state,
                                                       step, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]


# --------------------------------------------------------------------------
# optimizers on a toy problem (tests/test_optim_data.py's counterparts)
# --------------------------------------------------------------------------

def _descends(opt):
    w = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = opt.init(w)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for step in range(60):
        _, g = value_and_grad(loss)(w)
        w, state, _ = opt.update(g, state, w, torch.tensor(step))
    return float(loss(w))


def test_adamw_descends():
    assert _descends(AdamW(lr=lambda s: 0.1)) < 1e-2


def test_adafactor_descends():
    assert _descends(Adafactor(lr=lambda s: 0.1)) < 1e-1


def test_global_norm_and_clip_match_jax():
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5, 3).astype(np.float32),
            "b": {"c": rng.randn(7).astype(np.float32) * 10}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = tree_map(torch.from_numpy, tree)
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=ULP)
    for max_norm in (1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tc, tn = topt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=ULP)
        for k in ("a",):
            _close(tc[k], jc[k], 2 * ULP, k)
        _close(tc["b"]["c"], jc["b"]["c"], 2 * ULP, "c")


def test_stacked_layout_round_trips():
    """``stacked`` folds per-layer lists (nested too) into JAX's stacked
    leaves, and ``assign`` writes a stacked value back into the layers."""
    layers = [{"w": torch.full((2, 3), float(i)),
               "m": [torch.full((4,), float(10 * i + j)) for j in range(2)]}
              for i in range(3)]
    s = topt.stacked({"blocks": layers, "e": torch.ones(5)})
    assert s["e"].shape == (5,) and s["blocks"]["w"].shape == (3, 2, 3)
    assert s["blocks"]["m"].shape == (3, 2, 4)
    m = s["blocks"]["m"].value()
    assert float(m[2, 1, 0]) == 21.0
    s["blocks"]["m"].assign(m + 1)
    assert float(layers[2]["m"][1][0]) == 22.0


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cosine", "constant", "linear_warmup"])
def test_schedules_match_jax(name):
    make = {"cosine": lambda m: m.cosine_schedule(3e-4, 10, 50),
            "constant": lambda m: m.constant_schedule(0.1),
            "linear_warmup": lambda m: m.linear_warmup(1e-3, 7)}[name]
    js, ts = make(jsched), make(tsched)
    for step in range(0, 60, 3):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=4 * ULP, atol=0)


# --------------------------------------------------------------------------
# gradient accumulation
# --------------------------------------------------------------------------

def test_grad_accumulation_matches_full_batch():
    w = {"w": torch.ones((4, 3))}
    batch = torch.from_numpy(np.random.RandomState(0).randn(8, 4)
                             .astype(np.float32))

    def loss(p, b):
        return torch.mean((b @ p["w"]) ** 2)

    l1, g1 = value_and_grad(loss)(w, batch)
    l2, g2 = accumulated_value_and_grad(loss, 4)(w, batch)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(g1["w"].numpy(), g2["w"].numpy(), rtol=1e-5)


def test_grad_accumulation_matches_jax_on_a_model():
    """Two micro-batches of llama3-8b's smoke config: JAX's accumulated
    loss and gradients (loss 1e-5 relative, gradients 1e-4 of the
    largest)."""
    jcfg = jcfgs.get_smoke("llama3-8b").scaled(dtype=jnp.float32)
    tcfg = tcfgs.get_smoke("llama3-8b").scaled(dtype=torch.float32)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(2))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), device="cpu")
    b = tsyn.batch_for_step(tsyn.DataConfig(vocab=512, seq_len=16,
                                            global_batch=4), 0)
    jl, jg = jax.jit(j_accum(japi.loss(jcfg), 2))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = accumulated_value_and_grad(tapi.loss(tcfg), 2)(
        tp, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _close_trees(convert.params_to_numpy(tcfg, tg), jg, PARAM_TOL, "accum")


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

def test_quantize_matches_jax():
    """q bit for bit, the scale and the residual within 1 ulp, over steps
    of error feedback (ties at .5 round to even in both)."""
    rng = np.random.RandomState(1)
    g = (rng.randn(256) * 0.1).astype(np.float32)
    g[:4] = [0.5, -0.5, 1.5, 2.5]                   # exact halves after /s
    jr, tr = jnp.zeros(256), torch.zeros(256)
    for _ in range(5):
        jq, js, jr = jcomp.quantize(jnp.asarray(g), jr)
        tq, ts, tr = compression.quantize(torch.from_numpy(g), tr)
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=ULP)
        _close(tr, jr, ULP, "residual")


def test_compression_error_feedback_converges():
    g = torch.from_numpy((np.random.RandomState(1).randn(64) * 0.1)
                         .astype(np.float32))
    ef = compression.EFState(torch.zeros(64))
    acc_true = np.zeros(64)
    acc_deq = np.zeros(64)
    for _ in range(50):
        q, s, r = compression.quantize(g, ef.residual)
        ef = compression.EFState(r)
        acc_true += g.numpy()
        acc_deq += q.numpy().astype(np.float32) * float(s)
    np.testing.assert_allclose(acc_deq, acc_true, atol=0.05)


def test_compress_tree_round_trip():
    grads = {"a": torch.randn(3, 4), "b": [torch.randn(5), torch.randn(2)]}
    ef = compression.init_ef(grads)
    q, scales, new_ef = compression.compress_tree(grads, ef)
    assert q["b"][1].dtype == torch.int8
    assert isinstance(new_ef["a"], compression.EFState)
    deq = compression.decompress_tree(q, scales)
    for d, g, e in ((deq["a"], grads["a"], new_ef["a"]),
                    (deq["b"][0], grads["b"][0], new_ef["b"][0])):
        assert torch.allclose(d + e.residual, g, atol=1e-6)


# --------------------------------------------------------------------------
# step-indexed data
# --------------------------------------------------------------------------

def test_batch_for_step_matches_jax_bit_for_bit():
    """The same numpy, the same batches: tokens, labels and every frontend
    input, at several steps and seeds."""
    fe = {"frames": ((6, 8), np.float32), "patches": ((3, 5), np.float32)}
    for seed, step in ((0, 0), (0, 17), (3, 5)):
        jc = jsyn.DataConfig(vocab=1000, seq_len=32, global_batch=4,
                             seed=seed)
        tc = tsyn.DataConfig(vocab=1000, seq_len=32, global_batch=4,
                             seed=seed)
        a = jsyn.batch_for_step(jc, step, frontend=fe)
        b = tsyn.batch_for_step(tc, step, frontend=fe)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    s = tsyn.stream(tc, start_step=5)
    np.testing.assert_array_equal(next(s)["tokens"],
                                  jsyn.batch_for_step(jc, 5)["tokens"])


def test_data_step_indexed_determinism():
    cfg = tsyn.DataConfig(vocab=1000, seq_len=32, global_batch=4)
    a = tsyn.batch_for_step(cfg, 17)
    b = tsyn.batch_for_step(cfg, 17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = tsyn.batch_for_step(cfg, 18)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].max() < 1000 and a["tokens"].min() >= 0
    assert np.all(a["labels"][:, -1] == -1)


def test_prefetcher_matches_direct_and_survives_seek():
    cfg = tsyn.DataConfig(vocab=100, seq_len=8, global_batch=2)
    fn = lambda s: tsyn.batch_for_step(cfg, s)
    pf = Prefetcher(fn, start_step=0, depth=2)
    try:
        for s in range(5):
            got = pf.get(expect_step=s)
            np.testing.assert_array_equal(got["tokens"],
                                          jsyn.batch_for_step(
                                              jsyn.DataConfig(100, 8, 2),
                                              s)["tokens"])
        got = pf.get(expect_step=42)
        np.testing.assert_array_equal(got["tokens"], fn(42)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
