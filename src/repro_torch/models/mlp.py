"""Feed-forward layers (port of ``repro.models.mlp``): the SwiGLU MLP, the
MoE parameters and the group-local dropping MoE.

kimi-k2 decodes its experts through the expert plane
(``core.expertplane.moe_decode``); mixtral decodes through ``moe``, the
MaxText-style dropping formulation (top-k routing, a stable sort by
expert, capacity-bounded dispatch into per-expert buffers, batched expert
products, weighted combine).  The same function is the MoE layer of the
training forward (``models.lm``), at ``cfg.moe_capacity``; its router's
gradient flows through the sorted probabilities (``stable_order``'s
values), as JAX's flows through ``lax.top_k``'s.

Over DTensors the ``shard`` annotations sit at JAX's places, each weight
is gathered over ``dp`` before its product (``gather_dp``), and the
counts and the dispatch scatter are out-of-place ``index_add``/
``index_put`` (DTensor takes no plain tensor as an in-place target; the
plain path computes the same bits).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from ..core.batch import stable_order
from ..launch import mesh as mesh_lib
from ..launch.mesh import gather_dp
from .common import BATCH, DP, TP, ParamDef, dense, shard


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


def route(xg, router, topk: int):
    """The router of the dropping MoE: logits in x's dtype, then f32, then
    softmax; the top-k with ``lax.top_k``'s ties (lower index first); the
    gates renormalized.  xg [G, Tg, d] -> (probs [G, Tg, E], gate
    [G, Tg, K], expert [G, Tg, K] int32)."""
    logits = torch.einsum("gtd,de->gte", xg, gather_dp(router).to(xg.dtype)
                          ).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, order = stable_order(probs, descending=True)
    gate, expert = vals[..., :topk], order[..., :topk]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, expert


def moe(params, x, *, n_experts: int, topk: int, capacity_factor: float = 1.25,
        n_groups: int = 0):
    """x: [B, S, d] -> ([B, S, d], aux load-balancing loss).

    Tokens fall into ``n_groups`` groups (``gcd(B, 16)`` by default); the
    routing, the rank of each routed slot within its expert and the
    capacity-bounded dispatch are group-local.  A slot ranked at or past
    the capacity ``Cg`` goes to the overflow row ``E * Cg``, which is cut
    off: its token gets nothing from that expert.  The expert products are
    batched over the experts, each output in x's dtype (JAX's
    ``preferred_element_type=x.dtype``), silu and the gate product in f32.
    """
    B, S, d = x.shape
    T = B * S
    E, K = n_experts, topk
    G = n_groups or math.gcd(B, 16) or 1
    Tg = T // G
    Cg = max(int(Tg * K * capacity_factor / E), 1)
    Cg = -(-Cg // 4) * 4
    dev = x.device

    # the groups split over the batch axes, or over as many of their minor
    # axes as divide the group count (16 groups on 2 x 16 batch ranks: over
    # "data"; one long-context sequence is one group, whole on every rank)
    mesh = mesh_lib.current_mesh()
    gb = BATCH if mesh is None else mesh_lib.dividing_axes(mesh, BATCH, G)
    x_in = x
    if gb != BATCH:
        x = shard(x, (gb, None, None))
    xg = x.reshape(G, Tg, d)
    xg = shard(xg, (gb, None, None))
    probs, gate, expert = route(xg, params["router"], K)        # [G, Tg, *]

    # aux loss (Switch-style load balancing, global)
    me = probs.mean(dim=(0, 1))                                 # [E]
    flat = expert.reshape(-1).long()
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add(
        0, flat, torch.full(flat.shape, 1.0 / (T * K), dtype=torch.float32,
                            device=dev))
    aux = E * torch.sum(me * ce)

    # per-group rank within expert: a stable sort, segment starts by a
    # scatter-min, the rank scattered back (the sort is a permutation, so
    # that scatter has no duplicate targets)
    n = Tg * K
    flat_expert = expert.reshape(G, n).long()
    sort_idx = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, sort_idx)
    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(G, n)
    seg_start = torch.full((G, E), n, dtype=torch.int64, device=dev
                           ).scatter_reduce(1, sorted_expert, pos, "amin")
    rank_sorted = pos - torch.gather(seg_start, 1, sorted_expert)
    rank = torch.zeros((G, n), dtype=torch.int64, device=dev).scatter(
        1, sort_idx, rank_sorted)

    keep = rank < Cg
    dst = torch.where(keep, flat_expert * Cg + rank, E * Cg)    # overflow

    # group-local dispatch: only the overflow row takes duplicate targets,
    # and it is cut off
    src_tok = torch.arange(Tg, device=dev).repeat_interleave(K)
    rows = E * Cg + 1
    buf = torch.zeros((G * rows, d), dtype=x.dtype, device=dev)
    gdst = (dst + rows * torch.arange(G, device=dev)[:, None]).reshape(-1)
    buf = buf.index_put((gdst,), xg[:, src_tok].reshape(G * n, d))
    xe = buf.view(G, rows, d)[:, :-1].reshape(G, E, Cg, d)
    xe = shard(xe, (gb, None, None, None))

    # expert computation (batched SwiGLU), one product per expert over all
    # groups' slots
    xe_e = xe.transpose(0, 1).reshape(E, G * Cg, d)
    g_ = torch.bmm(xe_e, gather_dp(params["wg"]))
    i_ = torch.bmm(xe_e, gather_dp(params["wi"]))
    h = (torch.nn.functional.silu(g_.to(torch.float32))
         * i_.to(torch.float32)).to(x.dtype)
    ye = torch.bmm(h, gather_dp(params["wo"])).reshape(E, G, Cg, d
                                                      ).transpose(0, 1)
    ye = shard(ye, (gb, None, None, None))   # reverse exchange to dp

    # combine
    flat_y = torch.cat([ye.reshape(G, E * Cg, d),
                        torch.zeros((G, 1, d), dtype=ye.dtype, device=dev)],
                       dim=1)
    yt = torch.gather(flat_y, 1, dst[..., None].expand(G, n, d)
                      ).reshape(G, Tg, K, d)
    w = torch.where(keep.reshape(G, Tg, K), gate, 0.0).to(torch.float32)
    out = torch.einsum("gtkd,gtk->gtd", yt.to(torch.float32), w)
    out = out.reshape(B, S, d).to(x.dtype)
    if x is not x_in and isinstance(x_in, DTensor):
        # back to x's layout, so the gradient comes back in the groups' one
        out = out.redistribute(x_in.device_mesh, x_in.placements)
    return out, aux
