"""Attention (port of ``repro.models.attention``): GQA/MQA with chunked
(flash-style) training and prefill attention, sliding windows, cross
attention, the unchunked reference and single-token decode against a dense
cache.

Serve-time decode attends through the KV plane (``models.api._plane_attend``)
and an encoder-decoder's cross attention through ``full_attention`` against
the encoder memory held in the serve state; ``decode_attend`` is the dense
cache form, which JAX keeps beside it.  ``chunked_attention`` is plain
PyTorch, as it is plain ``jnp`` in JAX; its gradients come from autograd.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import DTensor

from ..launch import mesh as mesh_lib
from .common import BATCH, DP, TP, ParamDef, dense, rope, shard

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
    """[B, S, KVH, Dh] -> [B, S, KVH*G, Dh] by head-group repetition.  On
    a mesh the repeated heads are split over "model" as the query heads
    are, so the gradient reaches the repetition whole (DTensor cannot
    unflatten a split head dimension into (KVH, G))."""
    if groups == 1:
        return k
    b, s, kvh, dh = k.shape
    k = k[:, :, :, None, :].expand(b, s, kvh, groups, dh)
    return shard(k.reshape(b, s, kvh * groups, dh), (BATCH, None, TP, None))


def _sqrt_dh(Dh: int, device) -> torch.Tensor:
    return torch.sqrt(torch.full((), Dh, dtype=torch.float32, device=device))


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference unchunked attention, in JAX's order of operations: f32
    scores divided by sqrt(f32(Dh)), the mask, softmax, the weighted sum in
    f32, then v's dtype.  q: [B, Sq, H, Dh]; k/v: [B, Sk, KVH, Dh]."""
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    k = _repeat_kv(k, G)
    v = _repeat_kv(v, G)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / _sqrt_dh(
        Dh, q.device)
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


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, chunk_q: int = 512,
                      chunk_k: int = 512) -> torch.Tensor:
    """Flash-style attention with an online softmax over KV chunks.

    q: [B, Sq, H, Dh]; k/v: [B, Sk, KVH, Dh] (H = KVH * G).  ``window > 0``
    keeps the last ``window`` positions; ``q_offset`` is the absolute
    position of q[0] relative to k[0].  Returns [B, Sq, H, Dh] in v's dtype.

    JAX's order of operations: the chunk sizes halve until they divide
    Sq and Sk; the f32 scores are multiplied by ``1/sqrt(f32(Dh))``;
    masked scores are ``NEG_INF``; every kv chunk is visited in order, a
    wholly masked one too (its ``exp(0) = 1`` terms are wiped out by the
    first chunk that holds a real score, through ``alpha = 0``); the output
    is ``acc / max(l, 1e-30)``.
    """
    B, Sq, H, Dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    k = _repeat_kv(k, G)
    v = _repeat_kv(v, G)
    dev = q.device
    scale = 1.0 / _sqrt_dh(Dh, dev)

    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    while Sq % cq:
        cq //= 2
    while Sk % ck:
        ck //= 2
    nq, nk = Sq // cq, Sk // ck

    outs = []
    for qi in range(nq):
        qc = q[:, qi * cq:(qi + 1) * cq].float()
        q_pos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, cq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, Dh), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kc = k[:, ki * ck:(ki + 1) * ck].float()
            vc = v[:, ki * ck:(ki + 1) * ck].float()
            k_pos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + torch.einsum("bhqk,bkhd->bhqd", p, vc)
            m = m_new
        out = acc / torch.maximum(l, torch.full((), 1e-30, device=dev))
        outs.append(out.transpose(1, 2).to(v.dtype))         # [B, cq, H, Dh]
    return torch.cat(outs, dim=1)


def attend(params, x, positions, cfg, *, kv_override=None, causal=True,
           window=0, q_offset=0, chunked=True):
    """The attention block's body (the caller applies the pre-norm).
    RoPE goes on q always and on k only when k is computed here (cross
    attention passes ``kv_override``).  Returns (out [B, S, d_model],
    (k, v))."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = mesh_lib.split_heads(dense(x, params["wq"]), H)
    if kv_override is None:
        k = mesh_lib.split_heads(dense(x, params["wk"]), KVH)
        v = mesh_lib.split_heads(dense(x, params["wv"]), KVH)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
    q = rope(q, positions, cfg.rope_theta)
    fn = chunked_attention if chunked else full_attention
    out = per_shard(partial(fn, causal=causal, window=window,
                            q_offset=q_offset), q, k, v)
    out = dense(out.reshape(B, S, H * Dh), params["wo"])
    return out, (k, v)


def per_shard(fn, q, k, v):
    """``fn(q, k, v)``, the attention core.  On a mesh each rank runs it on
    its own shard of the batch and of the (repeated) heads
    (``mesh.local``): the core exchanges nothing across either dimension,
    and DTensor cannot flatten a batch and a head dimension split over
    two mesh axes into the products' one batch dimension (torch 2.11
    refuses it; 2.13 plans it so slowly that a multi-pod trace does not
    finish).  A dimension its axis does not divide stays whole."""
    mesh = mesh_lib.current_mesh()
    if mesh is None or not isinstance(q, DTensor):
        return fn(q, k, v)
    G = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, G), _repeat_kv(v, G)
    spec = (BATCH if q.shape[0] % mesh_lib.axis_size(mesh, BATCH) == 0
            else None, None,
            TP if q.shape[2] % mesh_lib.axis_size(mesh, TP) == 0 else None,
            None)
    return mesh_lib.local(fn, (spec,) * 3, spec)(q, k, v)


def decode_attend(params, x, position, cache_k, cache_v, cfg, *, window=0):
    """Single-token decode against a dense cache.

    x: [B, 1, d]; cache_k/v: [B, Smax, KVH, Dh]; position: [B] int (the
    index to write).  Returns (out [B, 1, d], new cache_k, new cache_v):
    new tensors, the caches given are left as they are, as in JAX."""
    B = x.shape[0]
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Smax = cache_k.shape[1]
    dev = x.device
    q = dense(x, params["wq"]).reshape(B, 1, H, Dh)
    k = dense(x, params["wk"]).reshape(B, 1, KVH, Dh)
    v = dense(x, params["wv"]).reshape(B, 1, KVH, Dh)
    q = rope(q, position[:, None], cfg.rope_theta)
    k = rope(k, position[:, None], cfg.rope_theta)

    at = (torch.arange(B, device=dev), position.long())
    cache_k = cache_k.index_put(at, k[:, 0].to(cache_k.dtype))
    cache_v = cache_v.index_put(at, v[:, 0].to(cache_v.dtype))

    G = H // KVH
    kk = _repeat_kv(cache_k, G)
    vv = _repeat_kv(cache_v, G)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / _sqrt_dh(
        Dh, dev)
    pos = torch.arange(Smax, device=dev)
    mask = pos[None, :] <= position[:, None]
    if window > 0:
        mask &= pos[None, :] > (position[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vv.float()).to(x.dtype)
    out = dense(out.reshape(B, 1, H * Dh), params["wo"])
    return out, cache_k, cache_v
