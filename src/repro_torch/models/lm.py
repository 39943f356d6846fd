"""Decoder-only LM parameters (port of ``repro.models.lm``): the block
definitions of every decoder-only family and the model's parameter tree.

Layers come in repeating groups: one attention + MLP (or MoE) layer for
``dense``, ``moe`` and ``vlm``; (mLSTM, sLSTM) for xLSTM (``ssm``); five
Mamba2 blocks and one application of the shared attention block for zamba2
(``hybrid``), whose shared block and two tail Mamba2 blocks live outside
the groups.  ``forward`` and ``loss_fn`` (training and prefill) wait for
ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import dataclasses

from ..configs import ArchConfig
from . import attention as attn
from . import mlp as mlp_lib
from . import ssm
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
    """Returns (per-group defs, n_groups, shared_defs)."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _attn_mlp_defs(cfg), cfg.n_layers, {}
    if fam == "ssm":          # xLSTM: alternating mLSTM / sLSTM
        g = {
            "mlstm": ssm.mlstm_defs(cfg.d_model, cfg.n_heads, cfg.dtype),
            "slstm": ssm.slstm_defs(cfg.d_model, cfg.n_heads, cfg.dtype),
        }
        return g, cfg.n_layers // 2, {}
    if fam == "hybrid":       # zamba2: 6 groups of (5 mamba2 + shared attn)
        mamba = ssm.mamba2_defs(cfg.d_model, cfg.ssm_state, cfg.dtype)
        g = {"mamba": stack_layers(mamba, 5)}
        shared = {"shared_attn": _attn_mlp_defs(
            dataclasses.replace(cfg, moe_experts=0)),
            "tail": stack_layers(mamba, 2)}
        return g, 6, shared
    raise ValueError(fam)


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
