"""Decoder-only LM (port of ``repro.models.lm``): the block definitions
of every decoder-only family, the model's parameter tree, and the training
and prefill forward pass with its loss.

Layers come in repeating groups: one attention + MLP (or MoE) layer for
``dense``, ``moe`` and ``vlm``; (mLSTM, sLSTM) for xLSTM (``ssm``); five
Mamba2 blocks and one application of the shared attention block for zamba2
(``hybrid``), whose shared block and two tail Mamba2 blocks live outside
the groups.  ``forward`` loops over the groups where JAX scans; with
``cfg.remat`` each group runs under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint`` with ``nothing_saveable``: only the group's input is
kept, the group is run again in the backward pass).  JAX's ``shard``
annotations are no-ops outside a mesh and the port has none.

The embedding is a lookup (``F.embedding``) where JAX multiplies a one-hot
matrix into the table: each output has a single nonzero term, so the
values are the same bits, and the backward pass on the card sums each
token's rows in a fixed order (a scatter with atomics would not), which
keeps a resumed run's losses equal to an uninterrupted one's.  The loss
picks each label's logit by ``gather`` where JAX multiplies a one-hot
matrix in: the same value, with no [B, S, vocab] temporary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import ArchConfig
from . import attention as attn
from . import mlp as mlp_lib
from . import ssm
from .common import DP, TP, ParamDef, dense, rms_norm, stack_layers


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


# --------------------------------------------------------------------------
# forward pass (train / prefill)
# --------------------------------------------------------------------------

class Aux(NamedTuple):
    moe_loss: torch.Tensor


def embed_tokens(cfg: ArchConfig, embed: torch.Tensor, tokens: torch.Tensor):
    """tokens [B, S] -> [B, S, d]: the rows of ``embed`` times sqrt(d_model)
    rounded to the table's dtype, as JAX rounds the weakly typed scalar."""
    x = F.embedding(tokens.long(), embed)
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                          device=x.device)


def run_group(fn, x, remat: bool):
    """``fn(x)`` under activation checkpointing when ``remat`` and
    autograd is recording (outside it, remat changes nothing)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _group_fwd(cfg: ArchConfig, shared_params, gi, gparams, x, positions):
    """One group; returns new x and its aux loss."""
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam in ("dense", "moe", "vlm"):
        h = rms_norm(x, gparams["ln1"])
        o, _ = attn.attend(gparams["attn"], h, positions, cfg,
                           window=cfg.sliding_window)
        x = x + o
        h = rms_norm(x, gparams["ln2"])
        if cfg.moe_experts:
            o, aux = mlp_lib.moe(gparams["moe"], h, n_experts=cfg.moe_experts,
                                 topk=cfg.moe_topk,
                                 capacity_factor=cfg.moe_capacity)
        else:
            o = mlp_lib.mlp(gparams["mlp"], h)
        x = x + o
    elif fam == "ssm":
        x, _ = ssm.mlstm_block(gparams["mlstm"], x, cfg)
        x, _ = ssm.slstm_block(gparams["slstm"], x, cfg)
    elif fam == "hybrid":
        for p in gparams["mamba"]:
            x, _ = ssm.mamba2_block(p, x, cfg)
        sp = shared_params["shared_attn"]
        h = rms_norm(x, sp["ln1"])
        o, _ = attn.attend(sp["attn"], h, positions, cfg)
        x = x + o
        h = rms_norm(x, sp["ln2"])
        x = x + mlp_lib.mlp(sp["mlp"], h)
    else:
        raise ValueError(fam)
    return x, aux


def forward(cfg: ArchConfig, params, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None):
    """tokens [B, S] -> (logits [B, S, vocab_padded] f32, Aux).

    For the vision family, ``patches`` [B, Np, frontend_dim] are projected
    by ``patch_proj`` and put before the tokens; the positions span the
    whole sequence and the logits of the last S positions are returned."""
    B, S = tokens.shape
    embed = params["embed"]
    x = embed_tokens(cfg, embed, tokens)
    if cfg.frontend == "vision" and patches is not None:
        pre = dense(patches.to(x.dtype), params["patch_proj"])
        x = torch.cat([pre, x], dim=1)
    St = x.shape[1]
    positions = torch.arange(St, device=x.device).expand(B, St)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, gparams in enumerate(params["blocks"]):
        x, a = run_group(lambda x, gi=gi, gp=gparams: _group_fwd(
            cfg, params, gi, gp, x, positions), x, cfg.remat)
        aux = aux + a

    if cfg.family == "hybrid":   # zamba2 tail layers
        for p in params["tail"]:
            x, _ = ssm.mamba2_block(p, x, cfg)

    x = rms_norm(x, params["final_ln"])
    if cfg.tie_embeddings:
        logits = torch.matmul(x, embed.t())
    else:
        logits = dense(x, params["lm_head"])
    if cfg.frontend == "vision" and patches is not None:
        logits = logits[:, -S:]
    return logits.to(torch.float32), Aux(aux)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Mean cross entropy over the labels >= 0 (JAX's masked mean)."""
    mask = (labels >= 0).to(torch.float32)
    labels = labels.long().clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    nll = (lse - picked) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(cfg: ArchConfig, params, batch) -> torch.Tensor:
    """Next-token cross entropy (+ 0.01 x the MoE aux loss)."""
    logits, aux = forward(cfg, params, batch["tokens"], batch.get("patches"))
    return next_token_loss(logits, batch["labels"]) + 0.01 * aux.moe_loss
