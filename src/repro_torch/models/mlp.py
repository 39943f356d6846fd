"""Feed-forward layers (port of ``repro.models.mlp``): the SwiGLU MLP and
the MoE parameters.

kimi-k2 decodes its experts through the expert plane
(``core.expertplane.moe_decode``).  The dropping MoE (``moe``), mixtral's
decode path and every family's training path, waits for ROADMAP Queue 1
item 9 and raises.
"""
from __future__ import annotations

import torch

from .common import DP, TP, ParamDef, dense


def mlp_defs(d_model: int, d_ff: int, dtype) -> dict:
    return {
        "wi": ParamDef((d_model, d_ff), (DP, TP), dtype=dtype),
        "wg": ParamDef((d_model, d_ff), (DP, TP), dtype=dtype),
        "wo": ParamDef((d_ff, d_model), (TP, DP), dtype=dtype),
    }


def mlp(params, x):
    h = torch.nn.functional.silu(dense(x, params["wg"]).to(torch.float32)
                                 ).to(x.dtype)
    return dense(h * dense(x, params["wi"]), params["wo"])


def moe_defs(d_model: int, d_ff: int, n_experts: int, shard_experts: bool,
             dtype) -> dict:
    # EP when the expert count divides the model axis; else TP inside experts
    e_axis, f_axis = (TP, None) if shard_experts else (None, TP)
    return {
        "router": ParamDef((d_model, n_experts), (DP, None),
                           dtype=torch.float32),
        "wi": ParamDef((n_experts, d_model, d_ff), (e_axis, DP, f_axis),
                       dtype=dtype),
        "wg": ParamDef((n_experts, d_model, d_ff), (e_axis, DP, f_axis),
                       dtype=dtype),
        "wo": ParamDef((n_experts, d_ff, d_model), (e_axis, f_axis, DP),
                       dtype=dtype),
    }


def moe(params, x, *, n_experts: int, topk: int, capacity_factor: float = 1.25,
        n_groups: int = 0):
    raise NotImplementedError(
        "models.mlp.moe (the dropping MoE: mixtral's decode and the "
        "training path) is not ported yet: ROADMAP Queue 1, item 9")
