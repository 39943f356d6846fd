"""Attention (port of ``repro.models.attention``): the parameters, the
head-group repetition and the unchunked reference attention.

Decode attends through the KV plane (``models.api._plane_attend``), and an
encoder-decoder's cross attention through ``full_attention`` against the
encoder memory held in the serve state.  The training and prefill attention
(``chunked_attention``, ``attend``) waits for the training slice of the port
(ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

import torch

from .common import DP, TP, ParamDef

NEG_INF = -1e30


def attn_defs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
              dtype) -> dict:
    return {
        "wq": ParamDef((d_model, n_heads * head_dim), (DP, TP), dtype=dtype),
        "wk": ParamDef((d_model, n_kv_heads * head_dim), (DP, TP), dtype=dtype),
        "wv": ParamDef((d_model, n_kv_heads * head_dim), (DP, TP), dtype=dtype),
        "wo": ParamDef((n_heads * head_dim, d_model), (TP, DP), dtype=dtype),
    }


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KVH, Dh] -> [B, S, KVH*G, Dh] by head-group repetition."""
    if groups == 1:
        return k
    b, s, kvh, dh = k.shape
    k = k[:, :, :, None, :].expand(b, s, kvh, groups, dh)
    return k.reshape(b, s, kvh * groups, dh)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference unchunked attention, in JAX's order of operations: f32
    scores divided by sqrt(f32(Dh)), the mask, softmax, the weighted sum in
    f32, then v's dtype.  q: [B, Sq, H, Dh]; k/v: [B, Sk, KVH, Dh]."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    k = _repeat_kv(k, G)
    v = _repeat_kv(v, G)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / torch.sqrt(
        torch.full((), Dh, dtype=torch.float32, device=q.device))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(v.dtype)
