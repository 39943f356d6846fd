"""Model API (port of ``repro.models.api``): one surface over all
families for the launchers, the trainer and the serving engine.

  * ``model_defs(cfg)`` / ``init_params``
  * ``loss(cfg)``                       — train/prefill forward + loss
  * ``make_train_step(cfg, opt)``       — (params, opt_state, step, batch)
                                          -> (params, opt_state, step + 1,
                                          loss, gnorm)
  * ``make_prefill_step(cfg)``          — (params, batch) -> last-token
                                          logits
  * ``init_decode_state(cfg, shape)``   — concrete serve state
  * ``decode_step(cfg, shape)``         — (params, state, tokens) ->
                                          (state, logits)

for every family: the decoder-only attention families (``dense``, ``moe``
through the expert plane or the dropping MoE, ``vlm``) through the dense,
window and sparse KV plane modes; xLSTM (``ssm``) over its recurrent
states; zamba2 (``hybrid``), whose shared attention block attends through
each group's own dense or sparse KV plane; and the encoder-decoder
(``encdec``), self-attention through the dense KV plane and cross attention
against the encoder memory held in the state.  A ``vlm``'s vision frontend
enters only the forward (prefill and training) path: decode never reads
``patch_proj``, as in JAX.  The train step's gradients come from
``torch.autograd`` (``tree.value_and_grad``) where JAX's come from
``jax.value_and_grad``; its optimizers (``optim``) update the parameters
and their state in place and return them.

Where the port departs from the JAX form, and why:

* **Layers are a list.**  JAX scans over stacked ``[L, ...]`` params and
  states; here ``params["blocks"]`` (``dec_blocks``, a group's ``mamba``,
  ``tail``), ``ServeState.kv`` and ``ServeState.extra`` hold lists of
  per-layer entries (a sparse layer's KV entry a list of shard states) and
  the step loops over them.
* **Planes in place.**  A step updates the KV and expert planes in place
  and returns a ``ServeState`` over the same planes with the new
  ``lengths`` and new recurrent and conv state tensors (JAX's are new
  arrays too; writing them back in place would cost one more pass over
  xLSTM's matrix memory each step).
* **The embedding is indexed** (``lm.embed_tokens``).  JAX multiplies a
  one-hot matrix into the embedding; each output has a single nonzero
  term, so a lookup gives the same bits without reading the whole table
  each step.  The scale ``sqrt(d_model)`` is a weakly typed Python float
  in JAX, rounded to the activations' dtype before the multiply, so the
  port rounds it too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from ..configs import ArchConfig, ShapeConfig
from ..core import expertplane, kvplane
from ..core import state as st
from ..tree import value_and_grad
from . import attention as attn_lib
from . import encdec as encdec_lib
from . import lm as lm_lib
from . import mlp as mlp_lib
from . import ssm as ssm_lib
from .common import dense, init_params as _init, rms_norm, rope

PAGE_TOKENS = 64          # KV page size (tokens) across the framework
SPARSE_TOPK = 64          # pages selected per sparse decode step (global)
SPARSE_LOCAL_FRAMES = 96  # frames per shard in sparse mode
FETCH_BUDGET = 4          # pages fetched per shard per step
KIMI_HOT_EXPERTS = 32     # resident experts per layer (kimi serve)


def model_defs(cfg: ArchConfig) -> dict:
    if cfg.family == "encdec":
        return encdec_lib.model_defs(cfg)
    return lm_lib.model_defs(cfg)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Every parameter drawn from one generator seeded with ``seed``, on
    ``device``, one tensor at a time."""
    dev = st.resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return _init(model_defs(cfg), g, dev)


def loss(cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        return functools.partial(encdec_lib.loss_fn, cfg)
    return functools.partial(lm_lib.loss_fn, cfg)


# --------------------------------------------------------------------------
# serve state construction
# --------------------------------------------------------------------------

def _kv_cfg_dense(cfg: ArchConfig, B: int, S: int) -> kvplane.KVPlaneConfig:
    NP = -(-S // PAGE_TOKENS)
    return kvplane.KVPlaneConfig(
        kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, page_tokens=PAGE_TOKENS,
        num_pages=NP, num_frames=B * NP, batch=B, dtype=cfg.dtype)


def _kv_cfg_window(cfg: ArchConfig, B: int) -> kvplane.KVPlaneConfig:
    NP = -(-cfg.sliding_window // PAGE_TOKENS)
    return kvplane.KVPlaneConfig(
        kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, page_tokens=PAGE_TOKENS,
        num_pages=NP, num_frames=B * NP, batch=B, dtype=cfg.dtype)


def _kv_cfg_sparse(cfg: ArchConfig, S: int, shards: int
                   ) -> kvplane.KVPlaneConfig:
    NP = -(-S // (PAGE_TOKENS * shards))
    frames = min(SPARSE_LOCAL_FRAMES, NP)
    return kvplane.KVPlaneConfig(
        kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, page_tokens=PAGE_TOKENS,
        num_pages=NP, num_frames=frames, batch=1,
        sparse_topk=min(max(SPARSE_TOPK // shards, 4), frames),
        fetch_budget=min(FETCH_BUDGET, frames), dtype=cfg.dtype)


def kv_plan(cfg: ArchConfig, shape: ShapeConfig, shards: int = 1
            ) -> tuple[kvplane.KVPlaneConfig | None, str | None]:
    """The KV plane config of each attention layer (or shared-attention
    application) and its mode ("dense", "window" or "sparse"), as
    ``decode_step`` picks them; ``(None, None)`` for xLSTM, which has no
    KV cache.  The encoder-decoder's self-attention is always dense."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return None, None
    if cfg.family == "encdec":
        return _kv_cfg_dense(cfg, B, S), "dense"
    if shape.kind == "decode_long" and cfg.sliding_window:
        return _kv_cfg_window(cfg, B), "window"
    if shape.kind == "decode_long":
        return _kv_cfg_sparse(cfg, S, shards), "sparse"
    return _kv_cfg_dense(cfg, B, S), "dense"


class ServeState(NamedTuple):
    """Serve state: per-group lists inside, by family:

    * dense/moe/vlm: ``kv`` [L] KV plane states ([L][D] if sparse),
      ``extra`` [L] expert plane states or ``()``;
    * ssm: ``kv`` [L] dicts ``mlstm_s`` [B,H,dh,dh], ``mlstm_n``
      [B,H,dh,1] (f32) and ``slstm`` (c, n, m, h) [B,H,dh'] f32;
    * hybrid: ``kv`` [6] dicts ``conv`` [5] [B,3,C], ``ssm`` [5]
      [B,H,N,64] f32 and ``attn_kv`` (a KV plane state, a list of shard
      states if sparse); ``extra`` the tail's ``conv``/``ssm`` [2];
    * encdec: ``kv`` [L] KV plane states, ``extra`` the encoder memory
      ``k``/``v`` [L] [B, S_enc, KVH, Dh].
    """
    lengths: torch.Tensor         # [B] tokens already in context
    kv: Any
    extra: Any

    def clone(self) -> "ServeState":
        """A copy of every plane and state, for an oracle run beside this
        one."""
        def c(x):
            if isinstance(x, dict):
                return {k: c(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(c(y) for y in x)
            return x.clone()
        return ServeState(self.lengths.clone(), c(self.kv), c(self.extra))


def _n_groups(cfg: ArchConfig) -> int:
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    if cfg.family == "hybrid":
        return 6
    if cfg.family == "encdec":
        return cfg.dec_layers
    return cfg.n_layers


def _expert_cfg(cfg: ArchConfig) -> expertplane.ExpertPlaneConfig:
    return expertplane.ExpertPlaneConfig(
        n_experts=cfg.moe_experts, d_model=cfg.d_model, d_ff=cfg.d_ff,
        hot_slots=min(KIMI_HOT_EXPERTS, cfg.moe_experts), topk=cfg.moe_topk,
        fetch_budget=cfg.moe_topk, dtype=cfg.dtype)


def _uses_expert_plane(cfg: ArchConfig) -> bool:
    return bool(cfg.atlas_experts and cfg.moe_experts)


def _mamba_state(cfg: ArchConfig, B: int, n: int, dev) -> dict:
    """``n`` Mamba2 blocks' zero conv and SSM states."""
    d_inner = 2 * cfg.d_model
    H, N = d_inner // 64, cfg.ssm_state
    return {"conv": [torch.zeros((B, 3, d_inner + 2 * N), dtype=cfg.dtype,
                                 device=dev) for _ in range(n)],
            "ssm": [torch.zeros((B, H, N, 64), dtype=torch.float32,
                                device=dev) for _ in range(n)]}


def init_decode_state(cfg: ArchConfig, shape: ShapeConfig, shards: int = 1,
                      enc_len: int = 0, device="cuda") -> ServeState:
    """Zero-initialized serve state on ``device``.  ``enc_len`` is the
    encoder memory's length (encdec; ``max(S // 4, 128)`` if 0)."""
    dev = st.resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    L = _n_groups(cfg)
    fam = cfg.family
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)

    if fam == "ssm":   # xLSTM: recurrent states, O(1) in S
        H = cfg.n_heads
        dh_m = 2 * cfg.d_model // H
        dh_s = cfg.d_model // H

        def one():
            return {
                "mlstm_s": torch.zeros((B, H, dh_m, dh_m),
                                       dtype=torch.float32, device=dev),
                "mlstm_n": torch.zeros((B, H, dh_m, 1), dtype=torch.float32,
                                       device=dev),
                "slstm": ssm_lib.slstm_init_state(B, H, dh_s, dev),
            }
        return ServeState(lengths, [one() for _ in range(L)], ())

    kvc, mode = kv_plan(cfg, shape, shards)

    def plane():
        if mode == "sparse":
            return [kvplane.init(kvc, dev) for _ in range(shards)]
        return kvplane.init(kvc, dev)

    if fam == "hybrid":   # zamba2: per group 5 Mamba2 states + its KV plane
        kv = [dict(_mamba_state(cfg, B, 5, dev), attn_kv=plane())
              for _ in range(L)]
        return ServeState(lengths, kv, _mamba_state(cfg, B, 2, dev))

    kv = [plane() for _ in range(L)]
    if fam == "encdec":
        senc = enc_len or max(S // 4, 128)
        cross = {n: [torch.zeros((B, senc, cfg.n_kv_heads, cfg.hd),
                                 dtype=cfg.dtype, device=dev)
                     for _ in range(L)] for n in ("k", "v")}
        return ServeState(lengths, kv, cross)

    extra = ()
    if _uses_expert_plane(cfg):
        epc = _expert_cfg(cfg)
        extra = [expertplane.init(epc, dev) for _ in range(L)]
    return ServeState(lengths, kv, extra)


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens):
    return lm_lib.embed_tokens(cfg, params["embed"], tokens)[:, None, :]


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_ln"])
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t()).to(torch.float32)[:, 0]
    return dense(x, params["lm_head"]).to(torch.float32)[:, 0]


def _attn_qkv(gp, x, lengths, cfg):
    """Project one decode token; returns q [B,H,Dh], k/v [B,KVH,Dh]
    (RoPE applied at absolute positions)."""
    B = x.shape[0]
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, gp["wq"]).reshape(B, 1, H, Dh)
    k = dense(x, gp["wk"]).reshape(B, 1, KVH, Dh)
    v = dense(x, gp["wv"]).reshape(B, 1, KVH, Dh)
    q = rope(q, lengths[:, None], cfg.rope_theta)
    k = rope(k, lengths[:, None], cfg.rope_theta)
    return q[:, 0], k[:, 0], v[:, 0]


def _plane_attend(cfg, kvc, gp, x2d, kv, lengths, mode):
    """One attention application through the KV plane.  x2d: [B, 1, d]."""
    q, k, v = _attn_qkv(gp, x2d, lengths, cfg)
    if mode == "dense":
        kvplane.append_dense(kvc, kv, k, v, lengths)
        out, kv = kvplane.attend_dense(kvc, kv, q, lengths + 1)
    elif mode == "window":
        kvplane.append_window(kvc, kv, k, v, lengths)
        out, kv = kvplane.attend_window(kvc, kv, q, lengths + 1)
    else:  # sparse (sharded)
        kvplane.append_sharded(kvc, kv, k, v, lengths)
        out, kv = kvplane.sharded_sparse_decode(kvc, kv, q, lengths + 1)
    B = x2d.shape[0]
    out = dense(out.reshape(B, 1, cfg.n_heads * cfg.hd), gp["wo"])
    return out, kv


def _mamba_run(cfg, blocks, st, x):
    """x through Mamba2 blocks ``blocks`` with their states ``st``
    (``conv``/``ssm`` lists); returns x and the new states."""
    conv, ssm = [], []
    for p, c, s in zip(blocks, st["conv"], st["ssm"]):
        x, (c, s) = ssm_lib.mamba2_block(p, x, cfg, (c, s), chunk=1)
        conv.append(c)
        ssm.append(s)
    return x, {"conv": conv, "ssm": ssm}


def decode_step(cfg: ArchConfig, shape: ShapeConfig, shards: int = 1, *,
                kernel_impl: str = "auto", fetch_mode: str = "batch"):
    """Build the serve step: (params, state, tokens [B] int) ->
    (state, logits [B, vocab_padded] f32).  ``kernel_impl="ref"`` runs
    every kernel's plain version (the comparison path); ``fetch_mode``
    picks the expert plane's fetch executor."""
    fam = cfg.family
    B = shape.global_batch
    kvc, mode = kv_plan(cfg, shape, shards)
    if kvc is not None:
        kvc = dataclasses.replace(kvc, kernel_impl=kernel_impl)

    if fam == "ssm":   # xLSTM
        def step(params, state: ServeState, tokens):
            x = _embed_tokens(cfg, params, tokens)
            kv = []
            for gp, gs in zip(params["blocks"], state.kv):
                x, (s_m, n_m) = ssm_lib.mlstm_block(
                    gp["mlstm"], x, cfg, (gs["mlstm_s"], gs["mlstm_n"]),
                    chunk=1)
                x, s_s = ssm_lib.slstm_block(gp["slstm"], x, cfg,
                                             gs["slstm"])
                kv.append({"mlstm_s": s_m, "mlstm_n": n_m, "slstm": s_s})
            return (ServeState(state.lengths + 1, kv, state.extra),
                    _logits(cfg, params, x))
        return step

    if fam == "hybrid":   # zamba2
        def step(params, state: ServeState, tokens):
            x = _embed_tokens(cfg, params, tokens)
            lengths = state.lengths
            sp = params["shared_attn"]
            kv = []
            for gp, gs in zip(params["blocks"], state.kv):
                x, new = _mamba_run(cfg, gp["mamba"], gs, x)
                h = rms_norm(x, sp["ln1"])
                o, _ = _plane_attend(cfg, kvc, sp["attn"], h, gs["attn_kv"],
                                     lengths, mode)
                x = x + o
                h = rms_norm(x, sp["ln2"])
                x = x + mlp_lib.mlp(sp["mlp"], h)
                kv.append(dict(new, attn_kv=gs["attn_kv"]))
            x, tail = _mamba_run(cfg, params["tail"], state.extra, x)
            return (ServeState(lengths + 1, kv, tail),
                    _logits(cfg, params, x))
        return step

    if fam == "encdec":
        def step(params, state: ServeState, tokens):
            x = _embed_tokens(cfg, params, tokens)
            lengths = state.lengths
            cross = state.extra
            for i, gp in enumerate(params["dec_blocks"]):
                h = rms_norm(x, gp["ln1"])
                o, _ = _plane_attend(cfg, kvc, gp["self_attn"], h,
                                     state.kv[i], lengths, "dense")
                x = x + o
                # cross attention against the (static) encoder memory
                h = rms_norm(x, gp["lnx"])
                q = dense(h, gp["cross_attn"]["wq"]).reshape(
                    B, 1, cfg.n_heads, cfg.hd)
                o = attn_lib.full_attention(q, cross["k"][i], cross["v"][i],
                                            causal=False)
                o = dense(o.reshape(B, 1, cfg.n_heads * cfg.hd),
                          gp["cross_attn"]["wo"])
                x = x + o
                h = rms_norm(x, gp["ln2"])
                x = x + mlp_lib.mlp(gp["mlp"], h)
            return (ServeState(lengths + 1, state.kv, cross),
                    _logits(cfg, params, x))
        return step

    # decoder-only attention families (dense / moe / vlm)
    epc = None
    if _uses_expert_plane(cfg):
        epc = dataclasses.replace(_expert_cfg(cfg), kernel_impl=kernel_impl,
                                  fetch_mode=fetch_mode)

    def step(params, state: ServeState, tokens):
        x = _embed_tokens(cfg, params, tokens)
        lengths = state.lengths
        for i, gp in enumerate(params["blocks"]):
            h = rms_norm(x, gp["ln1"])
            o, _ = _plane_attend(cfg, kvc, gp["attn"], h, state.kv[i],
                                 lengths, mode)
            x = x + o
            h = rms_norm(x, gp["ln2"])
            if epc is not None:
                mp = gp["moe"]
                o2d, _ = expertplane.moe_decode(epc, state.extra[i],
                                                mp["router"], h[:, 0],
                                                mp["wi"], mp["wg"], mp["wo"])
                x = x + o2d[:, None, :]
            elif cfg.moe_experts:
                # the dropping MoE at its default capacity factor, as JAX's
                # decode calls it (not cfg.moe_capacity)
                o, _aux = mlp_lib.moe(gp["moe"], h, n_experts=cfg.moe_experts,
                                      topk=cfg.moe_topk)
                x = x + o
            else:
                x = x + mlp_lib.mlp(gp["mlp"], h)
        logits = _logits(cfg, params, x)
        return ServeState(lengths + 1, state.kv, state.extra), logits

    return step


# --------------------------------------------------------------------------
# step builders (train / prefill)
# --------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, opt):
    """(params, opt_state, step, batch) -> (params, opt_state, step + 1,
    loss, gnorm); ``opt.update`` writes the new parameters and optimizer
    state into the tensors it was given."""
    vg = value_and_grad(loss(cfg))

    def train_step(params, opt_state, step, batch):
        lv, grads = vg(params, batch)
        new_params, new_opt, gnorm = opt.update(grads, opt_state, params,
                                                step)
        return new_params, new_opt, step + 1, lv, gnorm

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """Prefill: the full forward, the last token's logits [B, vocab_padded]
    (the continuation's input)."""
    if cfg.family == "encdec":
        @torch.no_grad()
        def step(params, batch):
            enc_out = encdec_lib.encode(cfg, params, batch["frames"])
            logits = encdec_lib.decode_train(cfg, params, batch["tokens"],
                                             enc_out)
            return logits[:, -1]
        return step

    @torch.no_grad()
    def step(params, batch):
        logits, _ = lm_lib.forward(cfg, params, batch["tokens"],
                                   batch.get("patches"))
        return logits[:, -1]
    return step
