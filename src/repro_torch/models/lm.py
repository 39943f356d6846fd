"""Decoder-only LM parameters (port of ``repro.models.lm``): the block
definitions of the ``dense``, ``moe`` and ``vlm`` families and the model's
parameter tree.  ``forward`` and ``loss_fn`` (training and prefill) and the
``ssm``/``hybrid`` blocks wait for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from ..configs import ArchConfig
from . import attention as attn
from . import mlp as mlp_lib
from .common import DP, TP, ParamDef, stack_layers


def pad_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def _attn_mlp_defs(cfg: ArchConfig):
    d = {
        "ln1": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "attn": attn.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.dtype),
        "ln2": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
    }
    if cfg.moe_experts:
        shard_ep = cfg.moe_experts % 16 == 0
        d["moe"] = mlp_lib.moe_defs(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                                    shard_ep, cfg.dtype)
    else:
        d["mlp"] = mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.dtype)
    return d


def group_defs(cfg: ArchConfig) -> tuple[dict, int, dict]:
    """Returns (per-layer group defs, n_groups, shared_defs)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return _attn_mlp_defs(cfg), cfg.n_layers, {}
    raise NotImplementedError(
        f"the {cfg.family!r} family's blocks are not ported yet: ROADMAP "
        f"Queue 1, item 9")


def model_defs(cfg: ArchConfig) -> dict:
    vp = pad_vocab(cfg.vocab)
    g, n_groups, shared = group_defs(cfg)
    defs = {
        "embed": ParamDef((vp, cfg.d_model), (TP, DP), "embed", 0.02,
                          cfg.dtype),
        "blocks": stack_layers(g, n_groups),
        "final_ln": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        **shared,
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, vp), (DP, TP), dtype=cfg.dtype)
    if cfg.frontend == "vision":
        defs["patch_proj"] = ParamDef((cfg.frontend_dim, cfg.d_model),
                                      (None, DP), dtype=cfg.dtype)
    return defs
