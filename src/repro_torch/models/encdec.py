"""Encoder-decoder LM parameters (port of ``repro.models.encdec``, the
seamless-m4t family).

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings.  The decoder block is causal self-attention, cross attention
against the encoder memory, and an MLP.  Decode needs only the parameter
tree (``models.api`` holds the encoder memory in the serve state);
``encode``, ``decode_train`` and ``loss_fn`` wait for ROADMAP Queue 1,
item 4.
"""
from __future__ import annotations

from ..configs import ArchConfig
from . import attention as attn
from . import mlp as mlp_lib
from .common import DP, TP, ParamDef, stack_layers
from .lm import pad_vocab


def enc_block_defs(cfg: ArchConfig):
    return {
        "ln1": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "attn": attn.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.dtype),
        "ln2": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "mlp": mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def dec_block_defs(cfg: ArchConfig):
    return {
        "ln1": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "self_attn": attn.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd, cfg.dtype),
        "lnx": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "cross_attn": attn.attn_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, cfg.dtype),
        "ln2": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "mlp": mlp_lib.mlp_defs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def model_defs(cfg: ArchConfig) -> dict:
    vp = pad_vocab(cfg.vocab)
    return {
        "embed": ParamDef((vp, cfg.d_model), (TP, DP), "embed", 0.02,
                          cfg.dtype),
        "enc_blocks": stack_layers(enc_block_defs(cfg), cfg.enc_layers),
        "enc_ln": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "dec_blocks": stack_layers(dec_block_defs(cfg), cfg.dec_layers),
        "final_ln": ParamDef((cfg.d_model,), (None,), "ones", dtype=cfg.dtype),
        "lm_head": ParamDef((cfg.d_model, vp), (DP, TP), dtype=cfg.dtype),
    }
