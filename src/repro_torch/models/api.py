"""Model API, the decode half (port of ``repro.models.api``).

  * ``model_defs(cfg)`` / ``init_params``
  * ``init_decode_state(cfg, shape)``   — concrete serve state
  * ``decode_step(cfg, shape)``         — (params, state, tokens) ->
                                          (state, logits)

for the decoder-only attention families (``dense``, ``moe`` with
``atlas_experts``, ``vlm``), through the dense, window and sparse KV plane
modes and the expert plane.  A ``vlm``'s vision frontend enters only the
forward (prefill and training) path, which the port does not have yet:
decode never reads ``patch_proj``, as in JAX.  The ``ssm``, ``hybrid`` and
``encdec`` families, the dropping MoE and the training and prefill steps
wait for ROADMAP Queue 1 item 9 and raise.

Where the port departs from the JAX form, and why:

* **Layers are a list.**  JAX scans over stacked ``[L, ...]`` params and
  plane states; here ``params["blocks"]``, ``ServeState.kv`` and
  ``ServeState.extra`` are lists of per-layer entries (a sparse layer's KV
  entry a list of shard states) and the step loops over them.
* **State in place.**  A step updates the planes in place and returns a
  ``ServeState`` with the new ``lengths`` over the same planes.
* **The embedding is indexed.**  JAX multiplies a one-hot matrix into the
  embedding; each output has a single nonzero term, so ``embed[tokens]``
  gives the same bits without reading the whole table each step.  The
  scale ``sqrt(d_model)`` is a weakly typed Python float in JAX, rounded to
  the activations' dtype before the multiply, so the port rounds it too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..configs import ArchConfig, ShapeConfig
from ..core import expertplane, kvplane
from ..core import state as st
from . import lm as lm_lib
from . import mlp as mlp_lib
from .common import dense, init_params as _init, rms_norm, rope

PAGE_TOKENS = 64          # KV page size (tokens) across the framework
SPARSE_TOPK = 64          # pages selected per sparse decode step (global)
SPARSE_LOCAL_FRAMES = 96  # frames per shard in sparse mode
FETCH_BUDGET = 4          # pages fetched per shard per step
KIMI_HOT_EXPERTS = 32     # resident experts per layer (kimi serve)

_DECODER_ONLY = ("dense", "moe", "vlm")


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1, "
                               f"item 9")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _DECODER_ONLY:
        raise _unported(f"decode for the {cfg.family!r} family")


def model_defs(cfg: ArchConfig) -> dict:
    if cfg.family == "encdec":
        raise _unported("the encdec model")
    return lm_lib.model_defs(cfg)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Every parameter drawn from one generator seeded with ``seed``, on
    ``device``, one tensor at a time."""
    dev = st.resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return _init(model_defs(cfg), g, dev)


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
            ) -> tuple[kvplane.KVPlaneConfig, str]:
    """The KV plane config of each layer and its mode ("dense", "window" or
    "sparse"), as ``decode_step`` picks them."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode_long" and cfg.sliding_window:
        return _kv_cfg_window(cfg, B), "window"
    if shape.kind == "decode_long":
        return _kv_cfg_sparse(cfg, S, shards), "sparse"
    return _kv_cfg_dense(cfg, B, S), "dense"


class ServeState(NamedTuple):
    """Serve state: per-layer lists inside."""
    lengths: torch.Tensor         # [B] tokens already in context
    kv: Any                       # [L] KV plane states ([L][D] if sparse)
    extra: Any                    # [L] expert plane states, or ()

    def clone(self) -> "ServeState":
        """A copy of every plane, for an oracle run beside this one."""
        def c(x):
            if isinstance(x, (list, tuple)):
                return type(x)(c(y) for y in x)
            return x.clone()
        return ServeState(self.lengths.clone(), c(self.kv), c(self.extra))


def _n_groups(cfg: ArchConfig) -> int:
    """Layers of the decoder-only families (JAX also counts the ssm,
    hybrid and encdec groups, which wait for item 9)."""
    return cfg.n_layers


def _expert_cfg(cfg: ArchConfig) -> expertplane.ExpertPlaneConfig:
    return expertplane.ExpertPlaneConfig(
        n_experts=cfg.moe_experts, d_model=cfg.d_model, d_ff=cfg.d_ff,
        hot_slots=min(KIMI_HOT_EXPERTS, cfg.moe_experts), topk=cfg.moe_topk,
        fetch_budget=cfg.moe_topk, dtype=cfg.dtype)


def _uses_expert_plane(cfg: ArchConfig) -> bool:
    return bool(cfg.atlas_experts and cfg.moe_experts)


def init_decode_state(cfg: ArchConfig, shape: ShapeConfig, shards: int = 1,
                      device="cuda") -> ServeState:
    """Zero-initialized serve state on ``device``."""
    _check_family(cfg)
    dev = st.resolve_device(device)
    L = _n_groups(cfg)
    kvc, mode = kv_plan(cfg, shape, shards)
    if mode == "sparse":
        kv = [[kvplane.init(kvc, dev) for _ in range(shards)]
              for _ in range(L)]
    else:
        kv = [kvplane.init(kvc, dev) for _ in range(L)]
    extra = ()
    if _uses_expert_plane(cfg):
        epc = _expert_cfg(cfg)
        extra = [expertplane.init(epc, dev) for _ in range(L)]
    lengths = torch.zeros((shape.global_batch,), dtype=torch.int32,
                          device=dev)
    return ServeState(lengths, kv, extra)


# --------------------------------------------------------------------------
# decode step
# --------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens):
    embed = params["embed"]
    x = embed[tokens.long()]
    scale = torch.full((), math.sqrt(cfg.d_model), dtype=embed.dtype,
                       device=embed.device)
    return (x * scale)[:, None, :]                         # [B, 1, d]


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


def decode_step(cfg: ArchConfig, shape: ShapeConfig, shards: int = 1, *,
                kernel_impl: str = "auto", fetch_mode: str = "batch"):
    """Build the serve step: (params, state, tokens [B] int) ->
    (state, logits [B, vocab_padded] f32).  ``kernel_impl="ref"`` runs
    every kernel's plain version (the comparison path); ``fetch_mode``
    picks the expert plane's fetch executor."""
    _check_family(cfg)
    if cfg.moe_experts and not _uses_expert_plane(cfg):
        raise _unported("decode through the dropping MoE (mixtral)")
    kvc, mode = kv_plan(cfg, shape, shards)
    kvc = dataclasses.replace(kvc, kernel_impl=kernel_impl)
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
            else:
                x = x + mlp_lib.mlp(gp["mlp"], h)
        logits = _logits(cfg, params, x)
        return ServeState(lengths + 1, state.kv, state.extra), logits

    return step
