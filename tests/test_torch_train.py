"""The port's training and prefill forward (``repro_torch.models``:
``attention.chunked_attention``/``attend``/``decode_attend``, ``lm.forward``/
``loss_fn``, ``encdec.encode``/``decode_train``/``loss_fn``) against the
JAX package, values and gradients.

Inputs are drawn with numpy from a seed; JAX's parameters are carried into
the port with ``convert.params_from_numpy`` and the port's gradients back
with ``convert.params_to_numpy``.  Everything runs in f32.  Tolerances:

* attention outputs and gradients within 1e-5 of the largest |value| of
  each (q, k, v chunks of a few dozen positions: a handful of roundings);
* a model's loss within 1e-5 relative and each gradient leaf within 1e-4 of
  its largest |value| (two layers and a vocabulary's softmax: XLA and
  PyTorch sum in other orders); zamba2's within 1e-3: its 32 Mamba2 blocks
  and 6 attention applications are ill-conditioned enough that JAX's own
  gradients move by up to 3.3e-4 of the largest when every parameter moves
  by one ulp (seed 5 signs, the smoke config of this file);
* the port's decode against its own forward within 3e-3 (rtol and atol),
  the tolerance ``tests/test_models.py`` holds JAX's decode to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.configs import ArchConfig as JArchConfig
from repro.models import api as japi
from repro.models import attention as jattn
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.data.synthetic import DataConfig, batch_for_step
from repro_torch.launch.train import frontend_inputs
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.tree import value_and_grad

ATTN_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DEEP_GRAD_TOL = {"zamba2-1.2b": 1e-3}
DECODE_TOL = 3e-3


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max(initial=0.0))
    top = float(np.abs(want).max(initial=0.0))
    assert err <= tol * max(top, 1e-30), (what, err, top)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _close_trees(got: dict, want: dict, tol, what):
    """Leaf by leaf over JAX's stacked layout (numpy on both sides)."""
    g = dict(_leaves(got))
    w = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert g.keys() == w.keys(), (what, sorted(g), sorted(w))
    for name in w:
        _close(g[name], w[name], tol, f"{what} {name}")


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, Sq, Sk, H, KVH, Dh, causal, window, q_offset, chunk)
    "causal_gqa": (2, 64, 64, 8, 2, 16, True, 0, 0, 16),
    "window": (2, 64, 64, 4, 2, 16, True, 24, 0, 16),
    "window_first_chunk_masked": (1, 64, 64, 4, 4, 8, True, 8, 0, 16),
    "q_offset": (1, 32, 48, 4, 1, 16, True, 0, 16, 32),
    "odd_divisors_cross": (2, 24, 40, 4, 4, 8, False, 0, 0, 16),
    "mha_one_chunk": (1, 12, 12, 2, 2, 32, True, 0, 0, 512),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_jax(case):
    """Output and the gradients of q, k and v against a seeded cotangent,
    JAX's chunked_attention (through jax.vjp) against the port's (through
    autograd)."""
    B, Sq, Sk, H, KVH, Dh, causal, window, q_offset, chunk = ATTN_CASES[case]
    rng = np.random.RandomState(0)
    q = rng.randn(B, Sq, H, Dh).astype(np.float32)
    k = rng.randn(B, Sk, KVH, Dh).astype(np.float32)
    v = rng.randn(B, Sk, KVH, Dh).astype(np.float32)
    ct = rng.randn(B, Sq, H, Dh).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              chunk_q=chunk, chunk_k=chunk)

    out_j, vjp = jax.vjp(lambda q, k, v: jattn.chunked_attention(
        q, k, v, **kw), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(ct))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out_t = tattn.chunked_attention(qt, kt, vt, **kw)
    out_t.backward(torch.from_numpy(ct))
    _close(out_t.detach(), out_j, ATTN_TOL, f"{case} out")
    for name, t, j in zip("qkv", (qt, kt, vt), grads_j):
        _close(t.grad, j, ATTN_TOL, f"{case} d{name}")


def test_chunked_attention_equals_full():
    """The counterpart of tests/test_models.py's check, in the port:
    chunked == unchunked, with and without a window."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 64, 8, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 64, 2, 32).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 64, 2, 32).astype(np.float32))
    for window in (0, 24):
        a = tattn.chunked_attention(q, k, v, causal=True, window=window,
                                    chunk_q=16, chunk_k=16)
        b = tattn.full_attention(q, k, v, causal=True, window=window)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


def _attn_cfgs(**kw):
    base = dict(name="a", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab=256, **kw)
    return (JArchConfig(dtype=jnp.float32, **base),
            tcfgs.ArchConfig(dtype=torch.float32, **base))


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attend_matches_jax(window):
    """Single-token decode against a dense cache, three steps, each new
    cache and output against JAX's."""
    jcfg, tcfg = _attn_cfgs()
    defs = tattn.attn_defs(64, 4, 2, 16, torch.float32)
    rng = np.random.RandomState(1)
    params = {k: rng.randn(*d.shape).astype(np.float32) * 0.1
              for k, d in defs.items()}
    B, Smax = 3, 12
    ck = rng.randn(B, Smax, 2, 16).astype(np.float32)
    cv = rng.randn(B, Smax, 2, 16).astype(np.float32)
    pos = np.array([0, 4, 9], np.int32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jk, jv, tk, tv = jnp.asarray(ck), jnp.asarray(cv), torch.from_numpy(
        ck), torch.from_numpy(cv)
    for step in range(3):
        x = rng.randn(B, 1, 64).astype(np.float32)
        oj, jk, jv = jattn.decode_attend(jp, jnp.asarray(x), jnp.asarray(pos),
                                         jk, jv, jcfg, window=window)
        ot, tk2, tv2 = tattn.decode_attend(tp, torch.from_numpy(x),
                                           torch.from_numpy(pos), tk, tv,
                                           tcfg, window=window)
        assert not torch.equal(tk2, tk)        # the given cache is kept
        tk, tv = tk2, tv2
        _close(ot, oj, ATTN_TOL, f"step {step} out")
        _close(tk, jk, 1e-6, f"step {step} cache_k")
        _close(tv, jv, 0.0, f"step {step} cache_v")
        pos = pos + 1


# --------------------------------------------------------------------------
# the model's loss and gradients, every family
# --------------------------------------------------------------------------

LOSS_ARCHS = ["llama3-8b", "mixtral-8x7b", "kimi-k2-1t-a32b", "xlstm-350m",
              "zamba2-1.2b", "paligemma-3b", "seamless-m4t-medium"]


def _cfgs(arch, **kw):
    return (jcfgs.get_smoke(arch).scaled(dtype=jnp.float32, **kw),
            tcfgs.get_smoke(arch).scaled(dtype=torch.float32, **kw))


def _setup(arch, B=2, S=40, seed=0, **kw):
    """JAX params and the same in the port; a seeded batch (the launcher's
    stub frontend inputs included) as numpy."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), device="cpu")
    batch = batch_for_step(DataConfig(vocab=tcfg.vocab, seq_len=S,
                                      global_batch=B, seed=seed), 3,
                           frontend=frontend_inputs(tcfg, S) or None)
    return jcfg, tcfg, jp, tp, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """``api.loss(cfg)`` and its gradient for the smoke config of each
    family (dense, the dropping MoE with and without a window, ssm, hybrid,
    vlm with patches, encdec), with remat on and off: the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its largest |value|
    (zamba2's 1e-3, see the module's docstring)."""
    jcfg, tcfg, jp, tp, batch = _setup(arch, remat=remat)
    lj, gj = jax.jit(jax.value_and_grad(japi.loss(jcfg)))(jp, _jb(batch))
    lt, gt = value_and_grad(tapi.loss(tcfg))(tp, _tb(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    _close_trees(convert.params_to_numpy(tcfg, gt), gj,
                 DEEP_GRAD_TOL.get(arch, GRAD_TOL), arch)
    if tcfg.moe_experts:
        # the router learns: its gradient flows through the sorted
        # probabilities (torch.sort's values, as through lax.top_k's)
        for layer in gt["blocks"]:
            assert float(layer["moe"]["router"].abs().max()) > 0


def test_forward_vision_prefix_shapes():
    """A vlm's patches go before the tokens and only the last S positions'
    logits come back; without patches the tokens alone."""
    _, tcfg, _, tp, batch = _setup("paligemma-3b", S=8)
    tb = _tb(batch)
    with torch.no_grad():
        with_p, _ = tlm.forward(tcfg, tp, tb["tokens"], tb["patches"])
        without, _ = tlm.forward(tcfg, tp, tb["tokens"])
    assert with_p.shape == without.shape == (2, 8, tlm.pad_vocab(tcfg.vocab))
    assert with_p.dtype == torch.float32
    assert not torch.allclose(with_p, without)


@pytest.mark.parametrize("arch", ["llama3-8b", "paligemma-3b",
                                  "seamless-m4t-medium", "zamba2-1.2b"])
def test_prefill_step_matches_jax(arch):
    """``make_prefill_step``'s last-token logits against JAX's."""
    jcfg, tcfg, jp, tp, batch = _setup(arch, S=24)
    batch.pop("labels")
    want = jax.jit(japi.make_prefill_step(jcfg))(jp, _jb(batch))
    got = tapi.make_prefill_step(tcfg)(tp, _tb(batch))
    assert got.shape == want.shape
    _close(got, want, GRAD_TOL, arch)


# --------------------------------------------------------------------------
# the port's decode against its own forward (tests/test_models.py:35-51)
# --------------------------------------------------------------------------

BASE = dict(d_model=64, n_heads=4, vocab=256, dtype=torch.float32)
ROUNDTRIP = {
    "dense": dict(name="d", family="dense", n_layers=2, n_kv_heads=2,
                  d_ff=128),
    "moe": dict(name="m", family="moe", n_layers=2, n_kv_heads=2, d_ff=128,
                moe_experts=4, moe_topk=2, moe_capacity=8.0),
    "xlstm": dict(name="x", family="ssm", n_layers=4, n_kv_heads=4, d_ff=0),
    "zamba": dict(name="z", family="hybrid", n_layers=38, n_kv_heads=4,
                  d_ff=128, ssm_state=8),
}


@pytest.mark.parametrize("family", sorted(ROUNDTRIP))
def test_decode_equals_forward(family):
    cfg = tcfgs.ArchConfig(**ROUNDTRIP[family], **BASE)
    T, B = 10, 2
    params = tapi.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, T), generator=g)
    with torch.no_grad():
        ref, _ = tlm.forward(cfg, params, toks)
    shape = tcfgs.ShapeConfig("t", 64, B, "decode")
    state = tapi.init_decode_state(cfg, shape, device="cpu")
    step = tapi.decode_step(cfg, shape)
    outs = []
    for t in range(T):
        state, lg = step(params, state, toks[:, t].to(torch.int32))
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_value_and_grad_gives_zero_for_unused_leaves():
    """A leaf the loss does not reach gets zeros, as jax.grad gives."""
    p = {"a": torch.ones(3), "b": torch.ones(2)}
    v, g = value_and_grad(lambda p: (p["a"] * 2).sum())(p)
    assert float(v) == 6.0 and not v.requires_grad
    assert torch.equal(g["a"], torch.full((3,), 2.0))
    assert torch.equal(g["b"], torch.zeros(2))
    assert not p["a"].requires_grad
