"""Attention parameters (port of ``repro.models.attention``).

Decode attends through the KV plane (``models.api._plane_attend``); the
training and prefill attention (``chunked_attention``, ``full_attention``,
``attend``) waits for the training slice of the port (ROADMAP Queue 1,
item 9).
"""
from __future__ import annotations

from .common import DP, TP, ParamDef


def attn_defs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
              dtype) -> dict:
    return {
        "wq": ParamDef((d_model, n_heads * head_dim), (DP, TP), dtype=dtype),
        "wk": ParamDef((d_model, n_kv_heads * head_dim), (DP, TP), dtype=dtype),
        "wv": ParamDef((d_model, n_kv_heads * head_dim), (DP, TP), dtype=dtype),
        "wo": ParamDef((n_heads * head_dim, d_model), (TP, DP), dtype=dtype),
    }
