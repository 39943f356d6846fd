"""The port's model decode path (``repro_torch.models``, ``configs`` and
``launch/serve.py --mode lm``) against the JAX package.

The decode cases build llama3-8b's and kimi-k2's smoke configs (2 layers)
in both packages, draw the params once in JAX and carry them to the port
(``convert.params_from_numpy``), carry the JAX serve state across too, and
decode the same seeded tokens step after step.  After every step:

* ``lengths`` and every int and bool field of every layer's KV plane (and
  shard) bit for bit; every expert plane field, the hot store included,
  bit for bit;
* the logits within 1e-4 of the largest |logit| in f32, within 3e-2 of it
  in bf16 (each bf16 matrix product rounds its output; XLA and PyTorch sum
  in other orders, so two layers end a few bf16 ulps apart); the KV frames
  within 1e-5 (f32) or 3e-2 (bf16) of the largest |frame|.

On the CPU the JAX plane runs its kernels' ``ref`` versions and the port
its plain versions.  In the expert cases the router's top-k decides what
the plane fetches, so each step asserts that every token's k-th and
(k+1)-th router probabilities (as the port computes them) stand apart by
more than 1e-4 (f32) or 2e-2 (bf16, about five bf16 ulps of the
activations) relative: a rounding tie then fails as a tie, not as a fault
of the port.
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


@pytest.mark.parametrize("arch", ["llama3-8b", "kimi-k2-1t-a32b",
                                  "mixtral-8x7b", "yi-9b"])
def test_param_defs_match_jax_at_full_width(arch):
    """Every parameter's name, shape and dtype at the assigned widths (no
    allocation): the port's per-layer list against JAX's stacked leaves."""
    jd = dict(_leaves(japi.model_defs(jcfgs.get_config(arch))))
    tdefs = tapi.model_defs(tcfgs.get_config(arch))
    L = len(tdefs["blocks"])
    assert L == jcfgs.get_config(arch).n_layers
    td = dict(_leaves({k: v for k, v in tdefs.items() if k != "blocks"}))
    for k, v in _leaves(tdefs["blocks"][0], "blocks."):
        td[k] = dataclasses.replace(v, shape=(L,) + v.shape)
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

def _margin_spy(monkeypatch, floor):
    """Assert the router's top-k margin on every expert plane call."""
    real = tep.moe_decode

    def spy(cfg, s, router, x, *a, **kw):
        p = torch.softmax(x.float() @ router.float(), dim=-1)
        p = p.sort(dim=-1, descending=True).values
        k = cfg.topk
        m = float(((p[:, k - 1] - p[:, k]) / p[:, k - 1]).min())
        assert m > floor, f"router tie (margin {m:.3g})"
        return real(cfg, s, router, x, *a, **kw)
    monkeypatch.setattr(tep, "moe_decode", spy)


def _compare_state(tcfg, tshape, js, ts, dt, shards, ctx):
    a = convert.serve_state_to_numpy(tcfg, tshape, ts, shards)
    b = jax.device_get(js)
    np.testing.assert_array_equal(a["lengths"], np.asarray(b.lengths))
    for k, v in a["kv"].items():
        w = np.asarray(getattr(b.kv, k))
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(v, w, err_msg=f"kv.{k} {ctx}")
        elif k.endswith("frames"):
            w = w.astype(np.float32)
            err = np.abs(v - w).max()
            assert err <= FRAME_TOL[dt] * max(np.abs(w).max(), 1e-30), \
                (k, ctx, err)
    if a["extra"]:
        for k, v in a["extra"].items():
            w = np.asarray(getattr(b.extra, k))
            if k.startswith("hot"):
                w = w.astype(np.float32)
            np.testing.assert_array_equal(v, w, err_msg=f"extra.{k} {ctx}")


def decode_both(jc, tc, kind, batch, seq, steps, *, shards=1, start=0,
                seed=1):
    """Decode ``steps`` seeded tokens through both packages from the same
    params and state; compare after every step.  Returns the port's final
    state and the JAX params (for follow-up checks)."""
    dt = "f32" if tc.dtype == torch.float32 else "bf16"
    jsh = jcfgs.ShapeConfig("test", seq, batch, kind)
    tsh = tcfgs.ShapeConfig("test", seq, batch, kind)
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tc, jax.device_get(jp), "cpu")
    js = japi.init_decode_state(jc, jsh, shards)
    js = js._replace(lengths=jnp.full((batch,), start, jnp.int32))
    ts = convert.serve_state_from_numpy(tc, tsh, jax.device_get(js), shards,
                                        "cpu")
    jstep = jax.jit(japi.decode_step(jc, jsh, shards))
    tstep = tapi.decode_step(tc, tsh, shards)
    rng = np.random.RandomState(seed)
    for i in range(steps):
        tok = rng.randint(0, jc.vocab, batch).astype(np.int32)
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


@pytest.mark.parametrize("arch,why", [
    ("xlstm-350m", "'ssm' family"), ("zamba2-1.2b", "'hybrid' family"),
    ("seamless-m4t-medium", "'encdec' family"),
    ("mixtral-8x7b", "dropping MoE")])
def test_unported_decode_paths_raise(arch, why):
    cfg = tcfgs.get_smoke(arch)
    sh = tcfgs.ShapeConfig("t", 256, 2, "decode")
    with pytest.raises(NotImplementedError, match="item 9") as e:
        tapi.decode_step(cfg, sh)
    assert why in str(e.value)
    with pytest.raises(NotImplementedError, match="item 9"):
        tmlp.moe({}, None, n_experts=4, topk=2)


def test_launcher_lm_mode_on_cpu(capsys):
    serve.main(["--mode", "lm", "--arch", "kimi-k2-1t-a32b", "--tokens", "3",
                "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve:lm] arch=kimi-k2-1t-a32b batch=2 decoded 3 tokens" in out
