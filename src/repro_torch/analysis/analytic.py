"""Analytic FLOPs / HBM-bytes / collective model per (arch x shape x mesh)
(port of ``repro.analysis.analytic``: the same formulas, the NVIDIA H100
SXM's rates).

The companion of the traced numbers of ``launch.dryrun`` (the FLOPs and
collectives a rank's traced step issues).  All quantities are PER DEVICE
per step, on JAX's production meshes: 256 devices as 16 x 16, or 512 as
2 x 16 x 16.

Conventions: bf16 activations/params (2 B), f32 logits/optimizer.
Causal attention scores+AV ~ 2*B*H*S^2*Dh per layer forward (the 0.5
causal factor applied to the 4*... dense count); backward = 2x forward.
"""
from __future__ import annotations

import dataclasses

from .. import configs as cfgs
from ..models.lm import pad_vocab

# NVIDIA H100 SXM constants (per card, NVIDIA's data sheet)
PEAK_FLOPS = 989.4e12      # dense bf16 FLOP/s on the tensor cores (H100 SXM)
HBM_BW = 3.35e12           # bytes/s of HBM3 (H100 SXM)
NVLINK_BW = 450e9          # bytes/s of NVLink 4 per direction (H100 SXM)

PAGE_TOKENS = 64
SPARSE_TOPK = 64


def override_layers(cfg, L: int):
    fam = cfg.family
    if fam == "ssm":
        return dataclasses.replace(cfg, n_layers=2 * L)
    if fam == "encdec":
        return dataclasses.replace(cfg, enc_layers=L, dec_layers=L,
                                   n_layers=2 * L)
    if fam == "hybrid":
        return cfg  # fixed 6-group structure; probe unsupported
    return dataclasses.replace(cfg, n_layers=L)


def layer_params(cfg) -> dict:
    """Per-layer parameter counts by component (one 'group' for ssm/hybrid
    counts its full contents / group count)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * H * hd + 2 * d * KVH * hd + H * hd * d
    out = {"attn": attn}
    if cfg.moe_experts:
        out["moe"] = cfg.moe_experts * 3 * d * ff + d * cfg.moe_experts
        out["moe_active"] = cfg.moe_topk * 3 * d * ff + d * cfg.moe_experts
    elif ff:
        out["mlp"] = 3 * d * ff
    if cfg.family == "ssm":   # mLSTM + sLSTM pair, per 2-layer group
        di = 2 * d
        mlstm = d * 2 * di + 3 * di * di + di * 2 * cfg.n_heads + di * d
        dff = int(4 / 3 * d)
        slstm = 4 * d * d + cfg.n_heads * (d // cfg.n_heads) ** 2 * 4 \
            + 2 * d * dff + dff * d
        out = {"mlstm": mlstm, "slstm": slstm}
    if cfg.family == "hybrid":
        di = 2 * d
        Hm = di // 64
        mamba = d * (2 * di + 2 * cfg.ssm_state + Hm) + di * d
        out = {"mamba": mamba, "shared_attn": attn + 3 * d * ff}
    return out


def total_params(cfg) -> dict:
    vp = pad_vocab(cfg.vocab)
    lp = layer_params(cfg)
    embed = vp * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    fam = cfg.family
    if fam == "ssm":
        body = (cfg.n_layers // 2) * (lp["mlstm"] + lp["slstm"])
        active = body
    elif fam == "hybrid":
        body = 32 * lp["mamba"] + lp["shared_attn"]
        active = 32 * lp["mamba"] + 6 * lp["shared_attn"]
    elif fam == "encdec":
        enc = cfg.enc_layers * (lp["attn"] + 3 * cfg.d_model * cfg.d_ff)
        dec = cfg.dec_layers * (2 * lp["attn"] + 3 * cfg.d_model * cfg.d_ff)
        body, active = enc + dec, enc + dec
    elif cfg.moe_experts:
        body = cfg.n_layers * (lp["attn"] + lp["moe"])
        active = cfg.n_layers * (lp["attn"] + lp["moe_active"])
    else:
        body = cfg.n_layers * (lp["attn"] + lp.get("mlp", 0))
        active = body
    return {"total": body + embed, "active": active + embed, "body": body,
            "embed": embed}


def _attn_flops_fwd(cfg, B, S, window=0):
    eff = min(window, S) if window else S
    return 2 * B * cfg.n_heads * S * eff * cfg.hd  # causal 0.5 applied


def cell_model(arch: str, shape_name: str, mesh_kind: str,
               layers_override: int = 0) -> dict:
    """The model of one cell; ``layers_override`` cuts the depth as the
    dry-run's ``--layers`` does (``override_layers``)."""
    cfg = cfgs.get_config(arch)
    if layers_override:
        cfg = override_layers(cfg, layers_override)
    shape = cfgs.SHAPES[shape_name]
    chips = 512 if mesh_kind == "multi" else 256
    dp = 32 if mesh_kind == "multi" else 16
    tp = 16
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    p = total_params(cfg)
    vp = pad_vocab(cfg.vocab)
    d = cfg.d_model

    rec = {"params_total": p["total"], "params_active": p["active"],
           "chips": chips}

    if shape.kind == "train":
        mat = 6 * p["active"] * tokens            # fwd 2ND + bwd 4ND
        attn = 3 * _attn_flops_fwd(cfg, B, S, cfg.sliding_window) \
            * (cfg.n_layers if cfg.family not in ("ssm", "hybrid") else 6)
        flops = (mat + attn) / chips
        # HBM: params+grads+opt traffic + activation r/w with full remat
        # (~2 fwd passes + 1 bwd): ~14 bytes/token/d per layer-ish
        layers = cfg.n_layers
        act_bytes = 14 * tokens * d * layers * 2 / chips
        wt_bytes = (p["total"] * 2 * 3 + p["total"] * 4 * 2) / chips
        hbm = act_bytes + wt_bytes
        # collectives: FSDP all-gather (fwd+bwd) + reduce-scatter grads over
        # dp; TP all-reduce of activations 4x/layer (fwd+bwd) over tp
        fsdp = 3 * p["body"] * 2 * (dp - 1) / dp / tp
        tp_act = 4 * 2 * layers * tokens * d * 2 * (tp - 1) / tp / chips
        logits_ar = tokens * vp * 4 / chips * 0  # logits stay sharded
        moe_a2a = 0.0
        if cfg.moe_experts:
            moe_a2a = 3 * 2 * layers * tokens * cfg.moe_topk * d * 2 / chips
        coll = fsdp + tp_act + logits_ar + moe_a2a
    elif shape.kind == "prefill":
        mat = 2 * p["active"] * tokens
        attn = _attn_flops_fwd(cfg, B, S, cfg.sliding_window) \
            * (cfg.n_layers if cfg.family not in ("ssm", "hybrid") else 6)
        flops = (mat + attn) / chips
        hbm = (p["total"] * 2 + 6 * tokens * d * cfg.n_layers * 2) / chips
        coll = (2 * 2 * cfg.n_layers * tokens * d * 2 * (tp - 1) / tp
                / chips)
    else:  # decode: one token per sequence
        mat = 2 * p["active"] * B
        if shape.kind == "decode_long" and not cfg.sliding_window \
                and cfg.family != "ssm":
            kv_tokens = SPARSE_TOKENS_READ = SPARSE_TOPK * PAGE_TOKENS
        elif cfg.sliding_window and shape.kind == "decode_long":
            kv_tokens = cfg.sliding_window
        else:
            kv_tokens = S
        layers = {"ssm": 0, "hybrid": 6}.get(cfg.family, cfg.n_layers)
        attn = 4 * B * cfg.n_heads * kv_tokens * cfg.hd * layers
        flops = (mat + attn) / chips
        kv_bytes = (2 * B * kv_tokens * cfg.n_kv_heads * cfg.hd * 2
                    * max(layers, 1))
        hbm = (p["active"] * 2 + kv_bytes) / chips
        # TP all-reduce per layer of B*d activations (attn out + mlp out)
        coll = 2 * max(layers, 1) * B * d * 2 * (tp - 1) / tp / chips

    rec.update({
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm,
        "collective_bytes_per_chip": coll,
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_s": hbm / HBM_BW,
        "t_collective_s": coll / NVLINK_BW,
        "model_flops_global": flops * chips,
    })
    terms = {"compute": rec["t_compute_s"], "memory": rec["t_memory_s"],
             "collective": rec["t_collective_s"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec
