"""The port's model decode path (``repro_torch.models``, ``configs`` and
``launch/serve.py --mode lm``) against the JAX package.

The decode cases build a smoke config (llama3-8b, kimi-k2, mixtral-8x7b,
paligemma-3b, xlstm-350m, zamba2-1.2b, seamless-m4t-medium) in both
packages, draw the params once in JAX and carry them to the port
(``convert.params_from_numpy``), carry the JAX serve state across too, and
decode the same seeded tokens step after step.  After every step:

* ``lengths`` and every int and bool field of every KV plane (and shard)
  bit for bit; every expert plane field, the hot store included, bit for
  bit;
* the logits within 1e-4 of the largest |logit| in f32, within 3e-2 of it
  in bf16 (each bf16 matrix product rounds its output; XLA and PyTorch sum
  in other orders, so two layers end a few bf16 ulps apart); every float
  field of the KV planes (frames, slabs, page summaries) and the encoder
  memory within 1e-5 (f32) or 3e-2 (bf16) of its largest |value|; in the
  recurrent families (xLSTM, zamba2) every float field within the logits'
  tolerances: their recurrent states sum over every earlier step, and
  each layer's input (zamba2's KV frames too) carries that sum.

On the CPU the JAX plane runs its kernels' ``ref`` versions and the port
its plain versions.  JAX's step is jitted, except for the recurrent
families (xLSTM, zamba2) in bf16: there XLA keeps excess precision through
each fused bf16 chain (zamba2 has 32 Mamba2 blocks), and the jitted step
stands several percent of the largest logit off JAX's own step run op by op
(``jax.disable_jit``), which rounds each operation as the port does; the
port is held to that one.  In the expert and dropping
MoE cases the router's top-k decides what runs, so each step asserts that
every token's k-th and (k+1)-th router probabilities (as the port computes
them) stand apart by more than 1e-4 (f32) or 2e-2 (bf16, about five bf16
ulps of the activations) relative: a rounding tie then fails as a tie, not
as a fault of the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.core import expertplane as tep
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
LOGIT_TOL = {"f32": 1e-4, "bf16": 3e-2}
FRAME_TOL = {"f32": 1e-5, "bf16": 3e-2}
MARGIN = {"f32": 1e-4, "bf16": 2e-2}


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def _cfg_fields(c):
    d = dataclasses.asdict(c)
    d["dtype"] = str(jnp.dtype(d["dtype"])) if not isinstance(
        d["dtype"], torch.dtype) else str(d["dtype"]).replace("torch.", "")
    return d


@pytest.mark.parametrize("arch", jcfgs.ARCHS)
def test_configs_match_jax(arch):
    """The exact assigned config and the smoke config, field by field,
    with the dtype mapped (``jnp.bfloat16`` -> ``torch.bfloat16``)."""
    for get in ("get_config", "get_smoke"):
        j, t = getattr(jcfgs, get)(arch), getattr(tcfgs, get)(arch)
        assert _cfg_fields(j) == _cfg_fields(t), (arch, get)
        assert j.hd == t.hd


def test_shapes_and_cells_match_jax():
    assert tcfgs.ARCHS == jcfgs.ARCHS
    assert tcfgs.LONG_SKIP == jcfgs.LONG_SKIP
    assert {k: dataclasses.astuple(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcfgs.SHAPES.items()}
    assert tcfgs.cells(True) == jcfgs.cells(True)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _stacked_defs(tree):
    """The port's defs with each list of n layers folded into a leading
    axis of n on its leaves, as JAX stacks them."""
    if isinstance(tree, list):
        one = _stacked_defs(tree[0])
        return _tree_map_defs(one, lambda d: dataclasses.replace(
            d, shape=(len(tree),) + d.shape))
    if isinstance(tree, dict):
        return {k: _stacked_defs(v) for k, v in tree.items()}
    return tree


def _tree_map_defs(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map_defs(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("arch", ["llama3-8b", "kimi-k2-1t-a32b",
                                  "mixtral-8x7b", "yi-9b", "xlstm-350m",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_param_defs_match_jax_at_full_width(arch):
    """Every parameter's name, shape and dtype at the assigned widths (no
    allocation): the port's per-layer lists against JAX's stacked leaves
    (zamba2's ``[6, 5, ...]`` Mamba2 groups, its unstacked shared block and
    ``[2, ...]`` tail; seamless's encoder and decoder stacks)."""
    jd = dict(_leaves(japi.model_defs(jcfgs.get_config(arch))))
    tdefs = tapi.model_defs(tcfgs.get_config(arch))
    L = len(tdefs["blocks" if "blocks" in tdefs else "dec_blocks"])
    assert L == japi._n_groups(jcfgs.get_config(arch)) == tapi._n_groups(
        tcfgs.get_config(arch))
    td = dict(_leaves(_stacked_defs(tdefs)))
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert jd[k].shape == td[k].shape, k
        assert jd[k].init == td[k].init and jd[k].scale == td[k].scale, k
        assert str(jnp.dtype(jd[k].dtype)) == str(td[k].dtype).replace(
            "torch.", ""), k


def test_init_params_is_seeded_and_layered():
    cfg = tcfgs.get_smoke("kimi-k2-1t-a32b")
    a = tapi.init_params(cfg, seed=3, device="cpu")
    b = tapi.init_params(cfg, seed=3, device="cpu")
    assert len(a["blocks"]) == cfg.n_layers
    assert a["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["blocks"][1]["moe"]["wo"], b["blocks"][1]["moe"]["wo"])
    assert not torch.equal(a["blocks"][0]["attn"]["wq"],
                           a["blocks"][1]["attn"]["wq"])
    assert bool((a["blocks"][0]["ln1"] == 1).all())
    # normal init: std = 1 / sqrt(fan_in), as in JAX
    w = tapi.init_params(tcfgs.get_smoke("llama3-8b"), 0, "cpu")[
        "blocks"][0]["mlp"]["wi"].float()
    assert abs(float(w.std()) * 8 - 1) < 0.1     # fan_in 64


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layers_match_jax(dt):
    from repro.models import common as jcommon
    from repro.models import mlp as jmlp
    jd, td = DT[dt]
    rng = np.random.RandomState(0)
    x = rng.randn(3, 1, 4, 32).astype(np.float32)
    pos = np.array([[5], [70], [1023]], np.int32)
    got = tcommon.rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), 5e5)
    want = jcommon.rope(jnp.asarray(x).astype(jd), jnp.asarray(pos), 5e5)
    tol = 1e-6 if dt == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)
    h = rng.randn(3, 1, 32).astype(np.float32)
    g = rng.rand(32).astype(np.float32) + 0.5
    got = tcommon.rms_norm(torch.from_numpy(h).to(td),
                           torch.from_numpy(g).to(td))
    want = jcommon.rms_norm(jnp.asarray(h).astype(jd), jnp.asarray(g).astype(jd))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * 4, rtol=0)
    p = {k: rng.randn(*s).astype(np.float32) * 0.2
         for k, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    got = tmlp.mlp({k: torch.from_numpy(v).to(td) for k, v in p.items()},
                   torch.from_numpy(h).to(td))
    want = jmlp.mlp({k: jnp.asarray(v).astype(jd) for k, v in p.items()},
                    jnp.asarray(h).astype(jd))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=(1e-5 if dt == "f32" else 2e-2)
                               * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("d_model", [64, 96])
def test_embedding_bit_for_bit_in_bf16(d_model):
    """``embed[tokens]`` times sqrt(d_model) rounded to bf16 gives JAX's
    one-hot product bits.  At d_model 96 the square root is not exact in
    bf16, so an unrounded scale would differ."""
    jc = jcfgs.get_smoke("llama3-8b").scaled(d_model=d_model)
    tc = tcfgs.get_smoke("llama3-8b").scaled(d_model=d_model)
    jp = japi.init_params(jc, jax.random.PRNGKey(4))
    tp = convert.params_from_numpy(tc, jax.device_get(jp), "cpu")
    tok = np.random.RandomState(0).randint(0, jc.vocab, 64).astype(np.int32)
    want = np.asarray(japi._embed_tokens(jc, jp, jnp.asarray(tok)).astype(
        jnp.float32))
    got = tapi._embed_tokens(tc, tp, torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    if d_model == 96:      # the unrounded scale would not match
        naive = (tp["embed"][torch.from_numpy(tok).long()] * 96 ** 0.5)
        assert not np.array_equal(naive.float().numpy(), want[:, 0])


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _margin(p, k, floor):
    p = p.reshape(-1, p.shape[-1]).sort(dim=-1, descending=True).values
    m = float(((p[:, k - 1] - p[:, k]) / p[:, k - 1]).min())
    assert m > floor, f"router tie (margin {m:.3g})"


def _margin_spy(monkeypatch, floor):
    """Assert the router's top-k margin on every expert plane call and
    every dropping MoE call."""
    real = tep.moe_decode

    def spy(cfg, s, router, x, *a, **kw):
        _margin(torch.softmax(x.float() @ router.float(), dim=-1), cfg.topk,
                floor)
        return real(cfg, s, router, x, *a, **kw)
    monkeypatch.setattr(tep, "moe_decode", spy)
    real_route = tmlp.route

    def route_spy(xg, router, topk):
        out = real_route(xg, router, topk)
        _margin(out[0], topk, floor)
        return out
    monkeypatch.setattr(tmlp, "route", route_spy)


def _flat(tree, prefix=""):
    """(path, array) of every leaf of a serve-state tree: dicts, named
    tuples (JAX's plane states), tuples and arrays."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _compare_state(tcfg, tshape, js, ts, dt, shards, ctx):
    a = convert.serve_state_to_numpy(tcfg, tshape, ts, shards)
    b = jax.device_get(js)
    np.testing.assert_array_equal(a["lengths"], np.asarray(b.lengths))
    got = dict(_flat({"kv": a["kv"], "extra": a["extra"]}))
    want = dict(_flat({"kv": b.kv, "extra": b.extra}))
    assert sorted(got) == sorted(want), ctx
    for k, w in want.items():
        v = got[k]
        assert v.shape == w.shape, (k, ctx, v.shape, w.shape)
        exact = w.dtype.kind in "biu" or k.startswith("extra.hot")
        if exact:
            np.testing.assert_array_equal(v, w.astype(v.dtype),
                                          err_msg=f"{k} {ctx}")
        else:      # the page summaries start at -inf/+inf
            w = w.astype(np.float32)
            fin = np.isfinite(w)
            np.testing.assert_array_equal(v[~fin], w[~fin],
                                          err_msg=f"{k} {ctx}")
            err = np.abs(v[fin] - w[fin]).max(initial=0)
            tol = (LOGIT_TOL if tcfg.family in ("ssm", "hybrid")
                   else FRAME_TOL)
            assert err <= tol[dt] * max(np.abs(w[fin]).max(initial=0),
                                        1e-30), (k, ctx, err)


def decode_both(jc, tc, kind, batch, seq, steps, *, shards=1, start=0,
                seed=1, eager=False, prepare=None):
    """Decode ``steps`` seeded tokens through both packages from the same
    params and state; compare after every step.  ``eager`` runs JAX's step
    op by op (``jax.disable_jit``); ``prepare(js)`` may fill the JAX state
    before it is carried across.  Returns the port's final state and
    params."""
    dt = "f32" if tc.dtype == torch.float32 else "bf16"
    jsh = jcfgs.ShapeConfig("test", seq, batch, kind)
    tsh = tcfgs.ShapeConfig("test", seq, batch, kind)
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tc, jax.device_get(jp), "cpu")
    js = japi.init_decode_state(jc, jsh, shards)
    js = js._replace(lengths=jnp.full((batch,), start, jnp.int32))
    if prepare is not None:
        js = prepare(js)
    ts = convert.serve_state_from_numpy(tc, tsh, jax.device_get(js), shards,
                                        "cpu")
    jstep = japi.decode_step(jc, jsh, shards)
    if not eager:
        jstep = jax.jit(jstep)
    tstep = tapi.decode_step(tc, tsh, shards)
    rng = np.random.RandomState(seed)
    for i in range(steps):
        tok = rng.randint(0, jc.vocab, batch).astype(np.int32)
        with jax.disable_jit(eager):
            js, jl = jstep(jp, js, jnp.asarray(tok))
        ts, tl = tstep(tp, ts, torch.from_numpy(tok))
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        err = np.abs(jl - tl.numpy()).max()
        assert err <= LOGIT_TOL[dt] * np.abs(jl).max(), (i, err)
        _compare_state(tc, tsh, js, ts, dt, shards, f"step {i}")
    return ts, tp


def _pair(arch, dt, **kw):
    jd, td = DT[dt]
    return (jcfgs.get_smoke(arch).scaled(dtype=jd, **kw),
            tcfgs.get_smoke(arch).scaled(dtype=td, **kw))


@pytest.mark.parametrize("arch,dt,seed", [
    ("llama3-8b", "f32", 1), ("llama3-8b", "bf16", 1),
    ("kimi-k2-1t-a32b", "f32", 1), ("kimi-k2-1t-a32b", "bf16", 2)])
def test_dense_decode_matches_jax(arch, dt, seed, monkeypatch):
    """decode (dense KV plane), 3 sequences, 6 steps; kimi-k2 through the
    expert plane (8 experts, 8 hot slots: the first steps fetch).  In bf16
    kimi-k2 decodes the tokens of seed 2: those of seed 1 bring a token
    whose 2nd and 3rd router probabilities lie 0.2% apart at step 3, which
    one bf16 ulp of the activations can swap."""
    _margin_spy(monkeypatch, MARGIN[dt])
    jc, tc = _pair(arch, dt)
    ts, _ = decode_both(jc, tc, "decode", 3, 256, 6, seed=seed)
    assert int(ts.lengths[0]) == 6
    if tc.moe_experts:
        assert int(ts.extra[0].access.sum()) > 0


@pytest.mark.parametrize("arch", ["llama3-8b", "kimi-k2-1t-a32b"])
def test_more_experts_than_slots_and_long_contexts(arch, monkeypatch):
    """kimi-k2 with 48 experts, top-6, over its 32 hot slots (the slots
    fill, then every fetch evicts), and llama3-8b from 190 tokens in
    context (pages 3 and 4 of 4).  Tokens of seed 2: seed 1's put two of
    kimi-k2's router probabilities 7e-5 apart."""
    _margin_spy(monkeypatch, MARGIN["f32"])
    kw = dict(moe_experts=48, moe_topk=6) if arch != "llama3-8b" else {}
    jc, tc = _pair(arch, "f32", **kw)
    ts, _ = decode_both(jc, tc, "decode", 4, 256, 8, start=190, seed=2)
    if kw:
        assert int((ts.extra[1].view("slot_of") >= 0).sum()) == 32


def test_window_decode_matches_jax():
    """decode_long with a sliding window (ring buffer of 2 pages), across
    the wrap at 128 tokens."""
    jc, tc = _pair("llama3-8b", "f32", sliding_window=128)
    ts, _ = decode_both(jc, tc, "decode_long", 2, 1024, 8, start=124)
    assert int(ts.lengths[0]) == 132


@pytest.mark.parametrize("arch,shards", [("llama3-8b", 1), ("llama3-8b", 2),
                                         ("kimi-k2-1t-a32b", 2)])
def test_sparse_decode_matches_jax(arch, shards, monkeypatch):
    """decode_long through the sparse hybrid plane (one sequence, 16 pages
    over ``shards`` shards, fetch budget 4 per shard), 70 tokens from an
    empty context: the append page moves from page 0 to page 1."""
    _margin_spy(monkeypatch, MARGIN["f32"])
    jc, tc = _pair(arch, "f32")
    ts, _ = decode_both(jc, tc, "decode_long", 1, 1024, 70, shards=shards)
    assert isinstance(ts.kv[0], list) and len(ts.kv[0]) == shards


def test_vlm_text_decode_matches_jax():
    """paligemma-3b's language model without its vision frontend: tied
    embeddings (the logits against ``embed``), one kv head, head_dim set
    apart from d_model / n_heads."""
    jc, tc = _pair("paligemma-3b", "f32", frontend="none")
    decode_both(jc, tc, "decode", 2, 256, 4)


def test_vlm_vision_config_decodes_like_jax(capsys):
    """paligemma-3b's real smoke config, vision frontend and all: decode
    never reads ``patch_proj`` (the frontend enters only the forward
    path), so the port decodes it as JAX's ``decode_step`` does, and the
    launcher's ``--mode lm`` serves it."""
    jc, tc = _pair("paligemma-3b", "f32")
    assert jc.frontend == tc.frontend == "vision"
    ts, tp = decode_both(jc, tc, "decode", 2, 256, 4)
    assert "patch_proj" in tp and int(ts.lengths[0]) == 4
    serve.main(["--mode", "lm", "--arch", "paligemma-3b", "--tokens", "2",
                "--batch", "2", "--device", "cpu"])
    assert "[serve:lm] arch=paligemma-3b batch=2 decoded 2 tokens" in \
        capsys.readouterr().out


def test_bf16_d96_decode_matches_jax():
    """A bf16 llama3-8b variant at d_model 96, where the embedding scale is
    not exact in bf16, through whole decode steps."""
    jc, tc = _pair("llama3-8b", "bf16", d_model=96)
    decode_both(jc, tc, "decode", 2, 128, 3)


def test_serve_state_round_trips_and_clones():
    jc, tc = _pair("kimi-k2-1t-a32b", "bf16")
    sh = tcfgs.ShapeConfig("t", 256, 2, "decode")
    ts = tapi.init_decode_state(tc, sh, device="cpu")
    step = tapi.decode_step(tc, sh)
    tp = tapi.init_params(tc, 0, "cpu")
    ts, _ = step(tp, ts, torch.tensor([1, 2], dtype=torch.int32))
    c = ts.clone()
    ts, _ = step(tp, ts, torch.tensor([3, 4], dtype=torch.int32))
    assert int(c.lengths[0]) == 1 and int(ts.lengths[0]) == 2
    d = convert.serve_state_to_numpy(tc, sh, c)
    back = convert.serve_state_from_numpy(tc, sh, d, device="cpu")
    e = convert.serve_state_to_numpy(tc, sh, back)
    for part in ("kv", "extra"):
        for k in d[part]:
            np.testing.assert_array_equal(d[part][k], e[part][k])


def test_ref_impl_equals_auto_on_the_cpu():
    """``kernel_impl="ref"`` is the plain comparison path; on the CPU the
    default path takes the same plain versions."""
    tc = tcfgs.get_smoke("kimi-k2-1t-a32b")
    sh = tcfgs.ShapeConfig("t", 256, 2, "decode")
    tp = tapi.init_params(tc, 0, "cpu")
    a = tapi.init_decode_state(tc, sh, device="cpu")
    b = a.clone()
    tok = torch.tensor([5, 6], dtype=torch.int32)
    _, la = tapi.decode_step(tc, sh)(tp, a, tok)
    _, lb = tapi.decode_step(tc, sh, kernel_impl="ref",
                             fetch_mode="reference")(tp, b, tok)
    assert torch.equal(la, lb)


# --------------------------------------------------------------------------
# the dropping MoE and the ssm / hybrid / encdec families
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dropping_moe_matches_jax_and_drops(dt):
    """``mlp.moe`` on [4, 64, d] (4 groups of 64 tokens, 8 experts top-2,
    capacity 20 a group) with routing skewed toward expert 0: its slots
    overflow, so tokens are dropped, in the same places in both packages.
    Each token's first and second experts stand out of its router logits
    by design (1.5 apart, over noise of about 0.15), so no top-2 decision
    is near a tie.  Output within the file's tolerance, the aux loss
    within 1e-5."""
    from repro.models import mlp as jmlp
    jd, td = DT[dt]
    rng = np.random.RandomState(2)
    d, f, E = 32, 48, 8
    T = 4 * 64
    first = np.where(rng.rand(T) < 0.6, 0, rng.randint(0, E, T))
    second = (first + rng.randint(1, E, T)) % E
    x = rng.randn(T, d).astype(np.float32) * 0.1
    x[np.arange(T), first] += 2.0
    x[np.arange(T), second] += 1.0
    x = x.reshape(4, 64, d)
    router = rng.randn(d, E).astype(np.float32) * 0.05
    router[np.arange(E), np.arange(E)] += 1.5
    p = {"router": router,
         **{k: rng.randn(E, *s).astype(np.float32) * 0.2
            for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}}
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jd)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else td)
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(td)
    probs, _, top = tmlp.route(tx, tp["router"], 2)
    _margin(probs, 2, MARGIN[dt])
    top = top.reshape(4, -1)
    cap = -(-max(int(64 * 2 * 1.25 / E), 1) // 4) * 4
    over = [int((top[g] == 0).sum()) - cap for g in range(4)]
    assert min(over) > 0, over                 # expert 0 drops in each group
    want, jaux = jmlp.moe(jp, jnp.asarray(x).astype(jd), n_experts=E, topk=2)
    got, taux = tmlp.moe(tp, tx, n_experts=E, topk=2)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == td and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=LOGIT_TOL[dt] * np.abs(want).max(),
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    # the drops matter: with room for every slot the output differs
    full, _ = tmlp.moe(tp, tx, n_experts=E, topk=2, capacity_factor=8.0)
    assert not torch.equal(full, got)


def _prefix(js, start):
    return js._replace(lengths=jnp.full(js.lengths.shape, start, jnp.int32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "xlstm-350m", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_other_family_decode_matches_jax(arch, dt, monkeypatch):
    """decode (the dense KV plane where the family attends), 3 sequences,
    4 steps: mixtral through the dropping MoE, xLSTM over its recurrent
    states, zamba2 (32 Mamba2 blocks, 6 applications of the shared
    attention, each with its own plane), seamless with its zero encoder
    memory.  xLSTM and zamba2 in bf16 against JAX run op by op."""
    _margin_spy(monkeypatch, MARGIN[dt])
    jc, tc = _pair(arch, dt)
    eager = jc.family in ("ssm", "hybrid") and dt == "bf16"
    ts, _ = decode_both(jc, tc, "decode", 3, 256, 4, eager=eager)
    assert int(ts.lengths[0]) == 4


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mixtral_window_decode_matches_jax(dt, monkeypatch):
    """mixtral's decode_long through the window plane (a window of 128
    tokens, a ring of 2 pages of 64), across the wrap at 128 tokens.
    Tokens of seed 2: in bf16 seed 1's put a token's 2nd and 3rd router
    probabilities 1.6% apart, within a few bf16 ulps of a tie."""
    _margin_spy(monkeypatch, MARGIN[dt])
    jc, tc = _pair("mixtral-8x7b", dt, sliding_window=128)
    ts, _ = decode_both(jc, tc, "decode_long", 2, 1024, 8, start=124,
                        seed=2)
    assert int(ts.lengths[0]) == 132
    assert ts.kv[0].page_table.numel() - 1 == 2 * 2      # 2 pages a sequence


@pytest.mark.parametrize("shards", [1, 2])
def test_zamba2_long_decode_matches_jax(shards):
    """zamba2's long_500k form: each of the 6 shared-attention
    applications through its own sparse plane (one sequence, 16 pages over
    ``shards`` shards, fetch budget 4 a shard), 70 tokens from an empty
    context: the append page moves from page 0 to page 1."""
    jc, tc = _pair("zamba2-1.2b", "f32")
    ts, _ = decode_both(jc, tc, "decode_long", 1, 1024, 70, shards=shards)
    assert len(ts.kv) == 6 and len(ts.kv[0]["attn_kv"]) == shards
    assert len(ts.extra["conv"]) == 2


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_seamless_cross_memory_decode_matches_jax(dt):
    """seamless with a seeded encoder memory of 40 positions (not the
    default length) in both packages, and 24 tokens already in context."""
    jc, tc = _pair("seamless-m4t-medium", dt)
    rng = np.random.RandomState(9)
    L, B, senc = jc.dec_layers, 2, 40
    mem = {n: rng.randn(L, B, senc, jc.n_kv_heads, jc.hd).astype(np.float32)
           for n in ("k", "v")}

    def prepare(js):
        js = js._replace(extra={n: jnp.asarray(a).astype(jc.dtype)
                                for n, a in mem.items()})
        return _prefix(js, 24)
    ts, _ = decode_both(jc, tc, "decode", B, 256, 4, prepare=prepare)
    assert ts.extra["k"][1].shape == (B, senc, tc.n_kv_heads, tc.hd)
    np.testing.assert_array_equal(ts.extra["v"][0].float().numpy(),
                                  np.asarray(jnp.asarray(mem["v"][0]).astype(
                                      jc.dtype).astype(jnp.float32)))
    sh = tcfgs.ShapeConfig("t", 256, 2, "decode")
    st = tapi.init_decode_state(tc, sh, enc_len=senc, device="cpu")
    assert st.extra["k"][0].shape[1] == senc
    assert tapi.init_decode_state(tc, sh, device="cpu").extra["k"][0].shape[
        1] == 128                                   # max(S // 4, 128)


@pytest.mark.parametrize("arch,kind,batch", [
    ("mixtral-8x7b", "decode_long", 2), ("xlstm-350m", "decode", 2),
    ("zamba2-1.2b", "decode", 2), ("zamba2-1.2b", "decode_long", 1),
    ("seamless-m4t-medium", "decode", 2)])
def test_new_trees_round_trip_through_convert(arch, kind, batch):
    """The params (nested ``mamba`` and ``tail`` lists, ``shared_attn``,
    ``enc_blocks``/``dec_blocks``) carry from JAX leaf for leaf; the serve
    state after a step (recurrent dicts, the sLSTM four-tuple, conv/ssm/
    attn_kv per group, the tail, the cross memory) goes to JAX's layout,
    with JAX's paths and shapes, and back, bit for bit; a clone is a deep
    copy."""
    jc, tc = _pair(arch, "bf16")
    jp = jax.device_get(japi.init_params(jc, jax.random.PRNGKey(1)))
    tp = convert.params_from_numpy(tc, jp, "cpu")
    got = dict(_flat(convert._tree_np(tp, None)))
    want = dict(_flat(jp))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.astype(np.float32),
                                      err_msg=k)
    sh = tcfgs.ShapeConfig("t", 1024, batch, kind)
    step = tapi.decode_step(tc, sh)
    ts = tapi.init_decode_state(tc, sh, device="cpu")
    ts, _ = step(tp, ts, torch.arange(batch, dtype=torch.int32))
    c = ts.clone()
    ts, _ = step(tp, ts, torch.arange(batch, dtype=torch.int32) + 3)
    assert int(c.lengths[0]) == 1 and int(ts.lengths[0]) == 2
    d = convert.serve_state_to_numpy(tc, sh, c)
    back = convert.serve_state_from_numpy(tc, sh, d, device="cpu")
    e = convert.serve_state_to_numpy(tc, sh, back)
    a, b = dict(_flat(d)), dict(_flat(e))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jsh = jcfgs.ShapeConfig("t", 1024, batch, kind)
    jst = jax.device_get(japi.init_decode_state(jc, jsh))
    assert {k: v.shape for k, v in _flat(d)} == {
        k: v.shape for k, v in _flat(jst)}


def test_launcher_lm_mode_on_cpu(capsys):
    serve.main(["--mode", "lm", "--arch", "kimi-k2-1t-a32b", "--tokens", "3",
                "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve:lm] arch=kimi-k2-1t-a32b batch=2 decoded 3 tokens" in out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "xlstm-350m", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_launcher_lm_mode_serves_every_family(arch, capsys):
    serve.main(["--mode", "lm", "--arch", arch, "--tokens", "2",
                "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve:lm] arch={arch} batch=2 decoded 2 tokens" in out
