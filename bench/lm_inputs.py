"""The inputs of a decode cell, made from the seed on the device: the
weights of a dense decoder, the seeded context of each layer's KV plane
and the first token.  The dense kit (``bench/lm_dense.py``) hands them to
the program; the reference (``bench/lm_reference.py``) makes them again,
layer by layer, with the same calls, so both sides get the same bits and
the reference reads none of the program's memory.

Every tensor comes from a generator of its own, seeded from the run's seed,
a stream id and an index (SplitMix64, as ``bench/traffic.py`` mixes), so a
layer can be made alone and in any order.  A layer's weights are one draw
of N(0, 1) in the served dtype over one flat buffer, each matrix then
scaled by ``1 / sqrt(fan_in)`` in place; norms are ones; the embedding is
N(0, 0.02**2), the head N(0, 1 / d).

The context (the traffic's ``context`` block) fills pages ``0 ..
context_tokens / page_tokens - 1`` of each layer: keys ``key_std * N(0,
1)``, values ``value_std * N(0, 1)``, and on a ``magnet_share`` of the
pages one row set to ``magnet_norm * u`` with ``u`` the unit vector of equal
entries, so those pages' summaries and attention stand out.
"""
from __future__ import annotations

import math

import torch

from . import traffic as tr

WEIGHTS, CONTEXT, TOKEN = 11, 12, 13        # stream ids
HEAD = -1                                   # index of the embedding/head


def dims(model: dict) -> dict:
    """The sizes of a dense decoder's ``model`` block (``ArchConfig``
    fields by name), with the head size and the padded vocabulary worked
    out as the port does (``head_dim`` 0: ``d_model / n_heads``; the
    vocabulary padded to a multiple of 128)."""
    d, H = int(model["d_model"]), int(model["n_heads"])
    hd = int(model.get("head_dim", 0)) or d // H
    V = int(model["vocab"])
    return {"L": int(model["n_layers"]), "d": d, "H": H,
            "KVH": int(model["n_kv_heads"]), "hd": hd,
            "ff": int(model["d_ff"]), "vocab": V, "vp": -(-V // 128) * 128,
            "experts": int(model.get("moe_experts", 0)),
            "topk": int(model.get("moe_topk", 0)),
            "theta": float(model.get("rope_theta", 1e4)),
            "eps": float(model.get("rms_norm_eps", 1e-6)),
            "dtype": getattr(torch, model.get("dtype", "bfloat16"))}


def layer_shapes(m: dict) -> dict:
    """One layer's matrices, in the order of the flat buffer."""
    d, H, KVH, hd, ff = m["d"], m["H"], m["KVH"], m["hd"], m["ff"]
    return {"wq": (d, H * hd), "wk": (d, KVH * hd), "wv": (d, KVH * hd),
            "wo": (H * hd, d), "mlp_wi": (d, ff), "mlp_wg": (d, ff),
            "mlp_wo": (ff, d)}


def generator(seed: int, sid: int, index: int, device) -> torch.Generator:
    """A generator of its own for stream ``sid``, item ``index``."""
    g = torch.Generator(device=device)
    g.manual_seed(tr.mix64_int(tr.mix64_int(seed) + sid * tr.GAMMA
                               + index))
    return g


def layer_weights(m: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s matrices (views of one flat buffer) and norms."""
    shapes = layer_shapes(m)
    n = sum(a * b for a, b in shapes.values())
    flat = torch.empty(n, dtype=m["dtype"], device=device)
    flat.normal_(generator=generator(seed, WEIGHTS, layer, device))
    out, at = {}, 0
    for name, (a, b) in shapes.items():
        w = flat[at:at + a * b].view(a, b)
        w.mul_(1.0 / math.sqrt(a))
        out[name] = w
        at += a * b
    for name in ("ln1", "ln2"):
        out[name] = torch.ones(m["d"], dtype=m["dtype"], device=device)
    return out


def embed_and_head(m: dict, seed: int, device) -> dict:
    """The embedding [vp, d], the final norm and the untied head [d, vp]."""
    d, vp = m["d"], m["vp"]
    flat = torch.empty(2 * vp * d, dtype=m["dtype"], device=device)
    flat.normal_(generator=generator(seed, WEIGHTS, HEAD, device))
    embed = flat[:vp * d].view(vp, d).mul_(0.02)
    head = flat[vp * d:].view(d, vp).mul_(1.0 / math.sqrt(d))
    return {"embed": embed, "lm_head": head,
            "final_ln": torch.ones(d, dtype=m["dtype"], device=device)}


def context_layer(m: dict, ctx: dict, pages: int, page_tokens: int,
                  seed: int, layer: int, device) -> tuple:
    """Layer ``layer``'s context: keys and values [KVH, pages, P, Dh] in the
    served dtype, as the traffic's ``context`` block states them."""
    g = generator(seed, CONTEXT, layer, device)
    shape = (m["KVH"], pages, page_tokens, m["hd"])
    k = torch.empty(shape, dtype=m["dtype"], device=device)
    k.normal_(generator=g).mul_(float(ctx["key_std"]))
    v = torch.empty(shape, dtype=m["dtype"], device=device)
    v.normal_(generator=g).mul_(float(ctx["value_std"]))
    n_mag = int(pages * float(ctx["magnet_share"]))
    if n_mag:
        mag = torch.randperm(pages, generator=g, device=device)[:n_mag]
        rows = torch.randint(0, page_tokens, (n_mag,), generator=g,
                             device=device)
        u = torch.full((m["hd"],), float(ctx["magnet_norm"])
                       / math.sqrt(m["hd"]), device=device)
        k[:, mag, rows] = u.to(m["dtype"])
    return k, v


def first_token(m: dict, seed: int, device) -> torch.Tensor:
    """The token fed to the first step, [1] int64."""
    return torch.randint(0, m["vocab"], (1,), device=device,
                         generator=generator(seed, TOKEN, 0, device))
