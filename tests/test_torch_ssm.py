"""The port's recurrent sequence mixers (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm``.

Each case draws its inputs (and the block's params, through JAX's
initializer) from a seed, runs both packages on the same values and
compares every output: with a fresh state and with a state carried over
from an earlier call (a random state, or the state the first call left).
f32 within 1e-5 of the largest |value| of each output, bf16 within 3e-2 of
it (each bf16 operation rounds in both packages; XLA may keep excess
precision inside a fused chain, so a few bf16 ulps apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.models import ssm as tssm

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}


def _close(got, want, dt, what):
    """Every leaf of ``got`` (tensors) within TOL of ``want`` (JAX)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, dt, f"{what}[{i}]")
        return
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= TOL[dt] * max(np.abs(w).max(), 1e-30), (what, err)


def _both(a, dt):
    """A numpy array as (JAX array, tensor) in the case's dtype."""
    jd, td = DT[dt]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("state", ["fresh", "carried"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_chunked_linear_rnn_matches_jax(chunk, dt, state):
    """8 steps (chunk 4 and 8: two chunks and one; chunk 1: the decode
    form, one step a chunk), 2 heads, dk 6, dv 5; a carried state runs a
    second call from the first one's final state."""
    rng = np.random.RandomState(chunk)
    B, S, H, dk, dv = 2, 8, 2, 6, 5
    q, k = (rng.randn(B, S, H, dk).astype(np.float32) * 0.5 for _ in "qk")
    v = rng.randn(B, S, H, dv).astype(np.float32)
    la = -rng.rand(B, S, H).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(k, dt), _both(v, dt)
    jla, tla = jnp.asarray(la), torch.from_numpy(la)
    js = ts = None
    if state == "carried":
        _, js = jssm.chunked_linear_rnn(jq, jk, jv, jla, chunk=chunk)
        _, ts = tssm.chunked_linear_rnn(tq, tk, tv, tla, chunk=chunk)
        _close(ts, js, dt, "first call's state")
    jy, js = jssm.chunked_linear_rnn(jq, jk, jv, jla, js, chunk=chunk)
    ty, ts = tssm.chunked_linear_rnn(tq, tk, tv, tla, ts, chunk=chunk)
    assert ty.dtype == DT[dt][1] and ts.dtype == torch.float32
    _close(ty, jy, dt, "y")
    _close(ts, js, dt, "state")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_linear_rnn_step_matches_jax(dt):
    rng = np.random.RandomState(3)
    B, H, dk, dv = 3, 2, 4, 6
    q, k = (rng.randn(B, H, dk).astype(np.float32) for _ in "qk")
    v = rng.randn(B, H, dv).astype(np.float32)
    la = -rng.rand(B, H).astype(np.float32)
    s = rng.randn(B, H, dk, dv).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(k, dt), _both(v, dt)
    jy, js = jssm.linear_rnn_step(jq, jk, jv, jnp.asarray(la), jnp.asarray(s))
    ty, ts = tssm.linear_rnn_step(tq, tk, tv, torch.from_numpy(la),
                                  torch.from_numpy(s))
    _close(ty, jy, dt, "y")
    _close(ts, js, dt, "state")


@pytest.mark.parametrize("state", ["fresh", "carried"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_matches_jax(dt, state):
    """Width 4 over 5 steps, and a single decode step from a carried
    window of 3 inputs."""
    rng = np.random.RandomState(5)
    B, C, W = 2, 12, 4
    S = 5 if state == "fresh" else 1
    (jx, tx) = _both(rng.randn(B, S, C).astype(np.float32), dt)
    (jw, tw) = _both(rng.randn(W, C).astype(np.float32), dt)
    js = ts = None
    if state == "carried":
        js, ts = _both(rng.randn(B, W - 1, C).astype(np.float32), dt)
    jy, jn = jssm._causal_conv(jx, jw, js)
    ty, tn = tssm._causal_conv(tx, tw, ts)
    assert ty.dtype == DT[dt][1]
    _close(ty, jy, dt, "y")
    _close(tn, jn, dt, "new state")


def _block_case(block, dt):
    """(JAX cfg, port cfg, JAX params, port params, JAX fn, port fn) of one
    block at its family's smoke widths (xLSTM: d_model 64, 4 heads;
    zamba2: d_model 64, ssm_state 8)."""
    jd, td = DT[dt]
    arch = "zamba2-1.2b" if block == "mamba2" else "xlstm-350m"
    jc = jcfgs.get_smoke(arch).scaled(dtype=jd)
    tc = tcfgs.get_smoke(arch).scaled(dtype=td)
    if block == "mamba2":
        defs = jssm.mamba2_defs(jc.d_model, jc.ssm_state, jd)
    else:
        defs = getattr(jssm, f"{block}_defs")(jc.d_model, jc.n_heads, jd)
    jp = jcommon.init_params(defs, jax.random.PRNGKey(7))
    tp = {k: convert._tensor(np.asarray(v), "cpu")
          for k, v in jax.device_get(jp).items()}
    # nonzero A_log / dt_bias so the decay is not the same in every head
    rng = np.random.RandomState(11)
    for name in ("A_log", "dt_bias"):
        if name in jp:
            a = rng.randn(*jp[name].shape).astype(np.float32) * 0.5
            jp[name], tp[name] = jnp.asarray(a), torch.from_numpy(a)
    return (jc, tc, jp, tp, getattr(jssm, f"{block}_block"),
            getattr(tssm, f"{block}_block"))


def _run(fn, p, x, cfg, state, block, chunk):
    if block == "slstm":
        return fn(p, x, cfg, state)
    return fn(p, x, cfg, state, chunk=chunk)


@pytest.mark.parametrize("state", ["fresh", "carried"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_block_matches_jax(block, dt, state):
    """Each block over 4 tokens (chunk 2) from a fresh state; the carried
    case then decodes 2 single tokens (chunk 1) from the state the first
    call left, as ``decode_step`` does."""
    jc, tc, jp, tp, jfn, tfn = _block_case(block, dt)
    rng = np.random.RandomState({"mamba2": 1, "mlstm": 2, "slstm": 3}[block])
    jx, tx = _both(rng.randn(2, 4, jc.d_model).astype(np.float32), dt)
    jy, js = _run(jfn, jp, jx, jc, None, block, 2)
    ty, ts = _run(tfn, tp, tx, tc, None, block, 2)
    assert ty.dtype == DT[dt][1]
    _close(ty, jy, dt, "y")
    _close(ts, js, dt, "state")
    if state == "carried":
        for i in range(2):
            jx, tx = _both(rng.randn(2, 1, jc.d_model).astype(np.float32), dt)
            jy, js = _run(jfn, jp, jx, jc, js, block, 1)
            ty, ts = _run(tfn, tp, tx, tc, ts, block, 1)
            _close(ty, jy, dt, f"decode {i} y")
            _close(ts, js, dt, f"decode {i} state")


def test_slstm_initial_state_and_hidden_width():
    """The sLSTM state starts at (0, 0, -10, 0); the GeGLU hidden is 4/3 of
    d_model rounded up to a multiple of 64, as in JAX."""
    c, n, m, h = tssm.slstm_init_state(2, 4, 8, "cpu")
    assert all(bool((t == 0).all()) for t in (c, n, h))
    assert bool((m == -10).all()) and m.dtype == torch.float32
    for d in (64, 1024, 100):
        j = jssm.slstm_defs(d, 4, jnp.float32)["ff_out"].shape
        t = tssm.slstm_defs(d, 4, torch.float32)["ff_out"].shape
        assert j == t and t[0] % 64 == 0
