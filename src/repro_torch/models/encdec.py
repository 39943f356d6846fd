"""Encoder-decoder LM (port of ``repro.models.encdec``, the seamless-m4t
family): its parameters, the encoder, the teacher-forced decoder and the
loss.

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings [B, S_enc, d_model].  The decoder block is causal
self-attention, cross attention against the encoder memory (no RoPE on its
keys; the queries at position 0), and an MLP.  Serve-time decode
(``models.api``) holds the encoder memory in the serve state.  With
``cfg.remat`` each block runs under activation checkpointing, as in
``models.lm``.
"""
from __future__ import annotations

import torch

from ..configs import ArchConfig
from . import attention as attn
from . import mlp as mlp_lib
from .common import DP, TP, ParamDef, dense, rms_norm, stack_layers
from .lm import embed_tokens, next_token_loss, pad_vocab, run_group


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


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_enc, d_model] (cast to ``cfg.dtype``) -> the encoder's
    output."""
    B, S, _ = frames.shape
    x = frames.to(cfg.dtype)
    positions = torch.arange(S, device=x.device).expand(B, S)

    def fwd(x, bp):
        h = rms_norm(x, bp["ln1"])
        o, _ = attn.attend(bp["attn"], h, positions, cfg, causal=False)
        x = x + o
        h = rms_norm(x, bp["ln2"])
        return x + mlp_lib.mlp(bp["mlp"], h)

    for bp in params["enc_blocks"]:
        x = run_group(lambda x, bp=bp: fwd(x, bp), x, cfg.remat)
    return rms_norm(x, params["enc_ln"])


def decode_train(cfg: ArchConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass -> logits [B, S, vocab_padded] f32."""
    B, S = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)

    def fwd(x, bp):
        h = rms_norm(x, bp["ln1"])
        o, _ = attn.attend(bp["self_attn"], h, positions, cfg)
        x = x + o
        h = rms_norm(x, bp["lnx"])
        kvh = cfg.n_kv_heads
        k = dense(enc_out, bp["cross_attn"]["wk"]).reshape(B, -1, kvh, cfg.hd)
        v = dense(enc_out, bp["cross_attn"]["wv"]).reshape(B, -1, kvh, cfg.hd)
        # no RoPE on cross attention (position-agnostic memory keys)
        o, _ = attn.attend(bp["cross_attn"], h, positions * 0, cfg,
                           kv_override=(k, v), causal=False)
        x = x + o
        h = rms_norm(x, bp["ln2"])
        return x + mlp_lib.mlp(bp["mlp"], h)

    for bp in params["dec_blocks"]:
        x = run_group(lambda x, bp=bp: fwd(x, bp), x, cfg.remat)
    x = rms_norm(x, params["final_ln"])
    return dense(x, params["lm_head"]).to(torch.float32)


def loss_fn(cfg: ArchConfig, params, batch) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, batch["tokens"], enc_out)
    return next_token_loss(logits, batch["labels"])
