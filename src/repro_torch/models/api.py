"""Model API (port of ``repro.models.api``): one surface over all
families for the launchers, the trainer and the serving engine.

  * ``model_defs(cfg)`` / ``init_params`` / ``param_shapes`` /
    ``param_pspecs`` / ``opt_state_pspecs``
  * ``batch_specs(cfg, shape)``         — input meta tensors + specs
  * ``serve_state_pspecs(cfg, shape)``  — the serve state's specs
  * ``loss(cfg)``                       — train/prefill forward + loss
  * ``make_train_step(cfg, opt)``       — (params, opt_state, step, batch)
                                          -> (params, opt_state, step + 1,
                                          loss, gnorm)
  * ``make_prefill_step(cfg)``          — (params, batch) -> last-token
                                          logits
  * ``init_decode_state(cfg, shape)``   — concrete serve state
  * ``serve_state_on_mesh`` / ``serve_state_whole`` — a serve state laid
                                          out on a model mesh, and back
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
  the step loops over them.  The spec trees follow: a per-layer spec has
  no layer axis, and a list of shard states has ``PerShard`` specs.
* **Planes in place.**  A step updates the KV and expert planes in place
  and returns a ``ServeState`` over the same planes with the new
  ``lengths`` and new recurrent and conv state tensors (JAX's are new
  arrays too; writing them back in place would cost one more pass over
  xLSTM's matrix memory each step).
* **Decode on a model mesh.**  Under ``launch.mesh.use_mesh`` with
  DTensor parameters, ``decode_step`` takes a state laid out by
  ``serve_state_on_mesh``: the planes are each rank's local planes, not
  DTensors (their trash rows and flat tables do not split evenly), and
  each plane call runs on them through ``launch.mesh.local`` (JAX's
  ``shard_map``) with q's heads gathered over "model": the attention
  repeats on each "model" rank of a dp coordinate, as with JAX's frames,
  whose KV heads are replicated over "model".  ``serve_state_whole``
  reads such a state back whole.
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
import sys
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..configs import ArchConfig, ShapeConfig
from ..core import batch as batch_lib
from ..core import expertplane, kvplane, paths
from ..core import state as st
from ..kernels import ops as kops
from ..tree import value_and_grad
from . import attention as attn_lib
from . import common
from . import encdec as encdec_lib
from . import lm as lm_lib
from . import mlp as mlp_lib
from . import replay as replay_lib
from . import ssm as ssm_lib
from ..launch import mesh as mesh_lib
from .common import DP, dense, init_params as _init, pspecs as _pspecs, \
    rms_norm, rope, shapes as _shapes

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


def param_shapes(cfg: ArchConfig):
    """The parameter tree as meta tensors (no storage)."""
    return _shapes(model_defs(cfg))


def param_pspecs(cfg: ArchConfig):
    return _pspecs(model_defs(cfg))


def _stacked_specs(tree):
    """The spec tree in JAX's stacked layout (``optim.optimizers.stacked``):
    a list of per-layer trees becomes one tree whose specs lead with the
    layer axis."""
    if isinstance(tree, dict):
        return {k: _stacked_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return mesh_lib.map_specs(lambda s: (None,) + tuple(s),
                                  _stacked_specs(tree[0]))
    return tree


def opt_state_pspecs(cfg: ArchConfig, opt_name: str):
    """Optimizer-state logical specs mirroring the parameter specs: AdamW's
    moments in the parameters' per-layer layout, Adafactor's factored
    statistics in JAX's stacked one (their specs keep the layer axis)."""
    ps = param_pspecs(cfg)
    if opt_name == "adamw":
        return {"mu": ps, "nu": ps}
    if opt_name == "adafactor":
        def per(spec):
            spec = tuple(spec)
            if len(spec) >= 2:
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"f": mesh_lib.map_specs(per, _stacked_specs(ps))}
    raise ValueError(opt_name)


def loss(cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        return functools.partial(encdec_lib.loss_fn, cfg)
    return functools.partial(lm_lib.loss_fn, cfg)


# --------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# --------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeConfig):
    """{name: (meta tensor, logical spec)} for the step's input."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    out = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = (meta((B, S)), ("batch", None))
        if shape.kind == "train":
            out["labels"] = (meta((B, S)), ("batch", None))
        if cfg.family == "encdec":
            senc = max(S // 4, 128)
            out["frames"] = (meta((B, senc, cfg.d_model), cfg.dtype),
                             ("batch", None, None))
        if cfg.frontend == "vision":
            out["patches"] = (meta((B, cfg.frontend_seq, cfg.frontend_dim),
                                   cfg.dtype), ("batch", None, None))
    else:  # decode / decode_long: one new token per sequence
        # batch=1 (long-context) cannot shard over dp -> replicate
        tok_spec = (DP,) if B > 1 else (None,)
        out["tokens"] = (meta((B,)), tok_spec)
    return out


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
        return torch.matmul(x, mesh_lib.gather_dp(params["embed"]).t()).to(
            torch.float32)[:, 0]
    return dense(x, params["lm_head"]).to(torch.float32)[:, 0]


def _attn_qkv(gp, x, lengths, cfg):
    """Project one decode token; returns q [B,H,Dh], k/v [B,KVH,Dh]
    (RoPE applied at absolute positions)."""
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    q = mesh_lib.split_heads(dense(x, gp["wq"]), H)
    k = mesh_lib.split_heads(dense(x, gp["wk"]), KVH)
    v = mesh_lib.split_heads(dense(x, gp["wv"]), KVH)
    q = rope(q, lengths[:, None], cfg.rope_theta)
    k = rope(k, lengths[:, None], cfg.rope_theta)
    return q[:, 0], k[:, 0], v[:, 0]


def _plane(kvc, mode, kv, q, k, v, lengths):
    """Append the token's k/v [B, KVH, Dh] to the plane ``kv`` and attend
    with q [B, H, Dh]; returns [B, H, Dh]."""
    if mode == "dense":
        kvplane.append_dense(kvc, kv, k, v, lengths)
        out, _ = kvplane.attend_dense(kvc, kv, q, lengths + 1)
    elif mode == "window":
        kvplane.append_window(kvc, kv, k, v, lengths)
        out, _ = kvplane.attend_window(kvc, kv, q, lengths + 1)
    else:  # sparse (sharded)
        kvplane.append_sharded(kvc, kv, k, v, lengths)
        out, _ = kvplane.sharded_sparse_decode(kvc, kv, q, lengths + 1)
    return out


def _mesh_plane(kvc, mode, mesh, kv, q, k, v, lengths):
    """``_plane`` on a model mesh, on this rank's local plane
    (``serve_state_on_mesh``) through ``launch.mesh.local``: q, k and v
    come in with their heads gathered over "model" (JAX keeps the frames'
    KV heads replicated over "model", so GSPMD attends with whole heads
    too), split over dp by batch where the plane is; the output is laid
    out so.  The attention repeats on each "model" rank of a dp
    coordinate.  A sparse plane's shards are the dp ranks
    (``kvplane.mesh_sparse_step``)."""
    if mode == "sparse":
        def fn(q, k, v, lengths):
            return kvplane.mesh_sparse_step(kvc, kv, k, v, q, lengths, mesh)
        b = None
    else:
        b = DP if kvc.batch > 1 else None
        lkvc = kvplane.local_config(
            kvc, mesh_lib.coordinate(mesh, DP)[1]) if b else kvc

        def fn(q, k, v, lengths):
            return _plane(lkvc, mode, kv, q, k, v, lengths)
    spec = (b, None, None)
    return mesh_lib.local(fn, (spec, spec, spec, (b,)), spec)(q, k, v,
                                                              lengths)


def _plane_attend(cfg, kvc, gp, x2d, kv, lengths, mode):
    """One attention application through the KV plane.  x2d: [B, 1, d].
    On a current mesh with DTensor activations, through ``_mesh_plane``."""
    q, k, v = _attn_qkv(gp, x2d, lengths, cfg)
    mesh = mesh_lib.current_mesh()
    if mesh is not None and isinstance(q, DTensor):
        out = _mesh_plane(kvc, mode, mesh, kv, q, k, v, lengths)
    else:
        out = _plane(kvc, mode, kv, q, k, v, lengths)
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
    picks the expert plane's fetch executor.

    A decoder-only step without the expert plane is a ``replay.Replayed``:
    on a card, with no model mesh current and the functions of
    ``STEP_MODULES`` as imported, it replays the whole step (embedding,
    every layer, the logits) from one captured CUDA graph, and then the
    ``lengths`` and logits it returns are the graph's own buffers, which
    its next replay overwrites (see ``replay.Replayed``; its
    ``replay_counts`` tally what it did).  Every other step, and every
    step on the CPU, runs eagerly."""
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
                q = mesh_lib.split_heads(dense(h, gp["cross_attn"]["wq"]),
                                         cfg.n_heads)
                o = attn_lib.per_shard(
                    functools.partial(attn_lib.full_attention, causal=False),
                    q, cross["k"][i], cross["v"][i])
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

    if epc is not None:
        return step
    return replay_lib.Replayed(step, _STEP_FUNCTIONS)


# --------------------------------------------------------------------------
# serve-state logical partition specs (mirrors init_decode_state)
# --------------------------------------------------------------------------

class PerShard(list):
    """The specs of a list of shard states (a sparse KV plane's), laid out
    one shard a rank over the ``dp`` axes: JAX's leading shard axis, sharded
    over ``dp``, which the port keeps as a list."""
    axis = DP


def _kv_state_pspecs(shard_batch: bool) -> kvplane.KVPlaneState:
    """One layer's (or one shard's) KV plane specs over JAX's logical
    shapes (``KVPlaneState.view``: no trash rows, ``[B, NP]`` tables)."""
    b = DP if shard_batch else None
    return kvplane.KVPlaneState(
        k_frames=(None, b, None, None), v_frames=(None, b, None, None),
        page_table=(b, None),
        # dense mode keeps a size-1 slab placeholder -> replicated
        k_slab=(None, None, None, None), v_slab=(None, None, None, None),
        kmax=(None, None, None), kmin=(None, None, None),
        cat=(b, None, None), psf=(b, None), hot_hint=(b, None, None),
        page_rows=(b, None), frame_page=(b,), clock=(b,), step=())


def _kv_pspecs(mode: str, shard_batch: bool, shards: int):
    if mode == "sparse":
        return PerShard([_kv_state_pspecs(False)] * shards)
    return _kv_state_pspecs(shard_batch)


def _expert_state_pspecs() -> expertplane.ExpertPlaneState:
    return expertplane.ExpertPlaneState(
        hot_wi=(None, DP, None), hot_wg=(None, DP, None),
        hot_wo=(None, None, DP), slot_of=(None,), expert_of=(None,),
        clock=(None,), access=(None,), step=())


def serve_state_pspecs(cfg: ArchConfig, shape: ShapeConfig, shards: int = 1):
    """The specs of ``init_decode_state``'s tree, in the port's structure
    (lists of layers, lists of shard states), over the planes' logical
    shapes."""
    B = shape.global_batch
    shard_b = B > 1
    b = DP if shard_b else None
    L = _n_groups(cfg)
    fam = cfg.family
    lengths = (DP,) if shard_b else (None,)

    if fam == "ssm":
        one = {"mlstm_s": (b, None, None, None),
               "mlstm_n": (b, None, None, None),
               "slstm": ((b, None, None),) * 4}
        return ServeState(lengths, [one] * L, ())

    _, mode = kv_plan(cfg, shape, shards)
    kv = _kv_pspecs(mode, shard_b, shards)
    if fam == "hybrid":
        def mamba(n):
            return {"conv": [(b, None, None)] * n,
                    "ssm": [(b, None, None, None)] * n}
        return ServeState(lengths, [dict(mamba(5), attn_kv=kv)] * L,
                          mamba(2))

    if fam == "encdec":
        cross = {n: [(b, None, None, None)] * L for n in ("k", "v")}
        return ServeState(lengths, [kv] * L, cross)

    extra = [_expert_state_pspecs()] * L if _uses_expert_plane(cfg) else ()
    return ServeState(lengths, [kv] * L, extra)


def _walk(x, spec, leaf, plane):
    """``x`` rebuilt with ``plane(x, spec)`` for each plane state (a KV
    plane, a list of sparse shard states under a ``PerShard`` spec, an
    expert plane) and ``leaf(x, spec)`` for every other tensor."""
    if isinstance(spec, PerShard) or isinstance(
            x, (kvplane.KVPlaneState, expertplane.ExpertPlaneState)):
        return plane(x, spec)
    if isinstance(x, dict):
        return {k: _walk(v, spec[k], leaf, plane) for k, v in x.items()}
    if isinstance(x, ServeState):
        return ServeState(*(_walk(v, sp, leaf, plane)
                            for v, sp in zip(x, spec)))
    if isinstance(x, (list, tuple)):
        return type(x)(_walk(v, sp, leaf, plane) for v, sp in zip(x, spec))
    return leaf(x, spec)


def serve_state_on_mesh(cfg: ArchConfig, shape: ShapeConfig,
                        state: ServeState, mesh, shards: int = 1
                        ) -> ServeState:
    """A whole serve state (the same on every rank; meta tensors too) laid
    out on ``mesh`` for ``decode_step`` under ``launch.mesh.use_mesh``.
    The tensors outside the planes (``lengths``, the recurrent and conv
    states, the encoder memory) become DTensors by their specs
    (``serve_state_pspecs``).  The planes become this rank's local planes,
    since their trash rows and flat tables do not split evenly: a
    batch-split dense or window plane is the plane of this rank's
    sequences (``kvplane.local_plane``; at batch 1 the whole plane, on
    every rank, as JAX's spec replicates it); a sparse layer's shard
    states (``shards`` = the dp ranks) keep this rank's own shard and
    ``None`` for the others; an expert plane keeps this rank's chunk of
    the hot store (``expertplane.local_plane``).  Dense planes are new
    tensors; the rest may share storage with ``state``, which the step
    then updates in place as the plain step does."""
    kvc, _ = kv_plan(cfg, shape, shards)
    r, n = mesh_lib.coordinate(mesh, DP)

    def plane(x, spec):
        if isinstance(spec, PerShard):
            if len(x) != n:
                raise ValueError(f"{len(x)} shard states on {n} "
                                 "data-parallel ranks")
            return [p if i == r else None for i, p in enumerate(x)]
        if isinstance(x, expertplane.ExpertPlaneState):
            return expertplane.local_plane(x, r, n)
        return kvplane.local_plane(kvc, x, r, n) if kvc.batch > 1 else x
    return _walk(state, serve_state_pspecs(cfg, shape, shards),
                 lambda x, spec: mesh_lib.distribute(x, mesh, spec), plane)


def serve_state_whole(cfg: ArchConfig, shape: ShapeConfig,
                      state: ServeState, mesh, shards: int = 1
                      ) -> ServeState:
    """The inverse of ``serve_state_on_mesh``: the whole serve state on
    every rank (each DTensor whole, the local planes all-gathered over dp
    and joined) -- how a host reads a mesh state."""
    kvc, _ = kv_plan(cfg, shape, shards)

    def gathered(p):
        """Every dp rank's ``p`` (a plane state), in dp order."""
        g = {k: mesh_lib.all_gather(getattr(p, k), mesh, DP)
             for k in p._fields}
        return [type(p)(**{k: g[k][i] for k in p._fields})
                for i in range(g[p._fields[0]].shape[0])]

    def plane(x, spec):
        if isinstance(spec, PerShard):
            return gathered(next(p for p in x if p is not None))
        if isinstance(x, expertplane.ExpertPlaneState):
            return expertplane.concat_planes(gathered(x))
        return (kvplane.concat_planes(kvc, gathered(x)) if kvc.batch > 1
                else x)
    return _walk(state, serve_state_pspecs(cfg, shape, shards),
                 lambda x, spec: x.full_tensor() if isinstance(x, DTensor)
                 else x, plane)


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


# --------------------------------------------------------------------------
# what a replayed decode step reaches (replay.may_replay)
# --------------------------------------------------------------------------

# the modules whose functions a decoder-only step calls: it replays from its
# graph only while each of their functions is the one bound here at import
STEP_MODULES = (sys.modules[__name__], common, mlp_lib, lm_lib, kvplane,
                batch_lib, paths, kops)
_STEP_FUNCTIONS = replay_lib.originals(STEP_MODULES)
