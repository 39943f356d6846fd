"""Kernel dispatch for the hybrid plane (port of ``repro.kernels.ops``).

``impl="auto"``: a CUDA tensor launches the hand-written CUDA kernel (or
the wrapper raises); a CPU tensor takes the plain PyTorch version in
``ref``.  There is no fallback from one to the other.  ``impl="ref"``
forces the plain version, for explicit comparisons only.
"""
from __future__ import annotations

import torch

from . import cat_decay as _cat_decay_mod
from . import cat_update as _cat_update_mod
from . import compact as _compact_mod
from . import gather_objects as _gather_mod
from . import paged_attention as _paged_attn_mod
from . import ref
from . import topk_pages as _scores_mod

_KERNEL_MODULES = {"gather_rows": _gather_mod,
                   "compact_pages": _compact_mod,
                   "cat_decay": _cat_decay_mod,
                   "page_scores": _scores_mod,
                   "paged_attention": _paged_attn_mod,
                   "cat_update": _cat_update_mod}


def _kernel(t: torch.Tensor, impl: str) -> bool:
    """True when this call goes to the CUDA kernel."""
    if impl == "ref" or t.device.type == "cpu":
        return False
    if impl != "auto":
        raise ValueError(f"unknown kernel impl {impl!r}")
    if not t.is_cuda:
        raise ValueError(f"no kernel for device {t.device}")
    return True


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset, and under
    ``paged_attention_mma`` those of paged_attention on the tensor cores."""
    counts = {k: m.launches for k, m in _KERNEL_MODULES.items()}
    counts["paged_attention_mma"] = _paged_attn_mod.launches_mma
    return counts


def reset_launch_counts() -> None:
    for m in _KERNEL_MODULES.values():
        m.launches = 0
    _paged_attn_mod.launches_mma = 0


def gather_rows(pool, idx, *, impl="auto", masked=True):
    """pool [N, D], idx [R] int32 -> [R, D].  With ``masked`` negative
    indices yield zero rows; ``masked=False`` lets the plain version skip
    the zero-fill where the caller drops those rows anyway (the kernel
    zero-fills either way)."""
    if _kernel(pool, impl):
        return _gather_mod.gather_rows(pool, idx)
    if not masked:
        return pool[idx.clamp_min(0)]
    return ref.gather_rows_ref(pool, idx)


def gather_pages(slab, page_ids, perm=None, *, impl="auto", masked=True):
    """Page assembly in ONE batched row gather: slab [KVH, S, P, Dh],
    page_ids [N] int32 (-1 = masked), optional perm [N, P] row permutation
    -> [KVH, N, P, Dh].  The slab is viewed page-granularly
    ([KVH*S, P*Dh]), so each fetched page is one gathered row."""
    KVH, S, P, Dh = slab.shape
    N = page_ids.shape[0]
    base = torch.arange(KVH, dtype=torch.int32, device=slab.device)[:, None] * S
    idx = torch.where(page_ids[None] >= 0, base + page_ids[None], -1)
    pages = gather_rows(slab.reshape(KVH * S, P * Dh), idx.reshape(-1),
                        impl=impl, masked=masked).reshape(KVH, N, P, Dh)
    if perm is not None:
        pages = torch.take_along_dim(pages, perm.long()[None, :, :, None],
                                     dim=2)
    return pages


def compact_pages(pool, plan, *, page_objs: int, impl="auto"):
    """pool [N, D], plan [M*P] flat row ids -> assembled pages [M, P, D]."""
    if _kernel(pool, impl):
        return _compact_mod.compact_pages(pool, plan, page_objs=page_objs)
    return ref.compact_pages_ref(pool, plan, page_objs)


def cat_decay(cat, car_ema, alloc, *, decay: float, impl="auto"):
    """Epoch-advance CAR EMA: cat [V, P] bool, car_ema [V] f32, alloc [V]
    int32 -> new_ema [V] f32."""
    if _kernel(cat, impl):
        return _cat_decay_mod.cat_decay(cat, car_ema, alloc, decay=decay)
    return ref.cat_decay_ref(cat, car_ema, alloc, decay)


def cat_update(cat_bits, vaddrs, *, page_objs: int, impl="auto"):
    """Packed CAT update: cat_bits [V, W] int32 (uint32 words), vaddrs [R]
    int32 (-1 = skip) -> (bits [V, W] int32, car [V] f32)."""
    if _kernel(cat_bits, impl):
        return _cat_update_mod.cat_update(cat_bits, vaddrs,
                                          page_objs=page_objs)
    return ref.cat_update_ref(cat_bits, vaddrs, page_objs)


def page_scores(q, kmax, kmin, *, impl="auto"):
    """q [B, H, Dh], kmax/kmin [KVH, NP, Dh] f32 -> [B, KVH, NP] f32."""
    if _kernel(q, impl):
        return _scores_mod.page_scores(q, kmax, kmin)
    return ref.page_scores_ref(q, kmax, kmin)


def paged_attention(q, k_pages, v_pages, page_table, page_lens, *,
                    impl="auto"):
    """q [B, H, Dh]; k/v_pages [KVH, F, P, Dh]; page_table/page_lens
    [B, NP] int32 -> (out [B, H, Dh], used [B, NP, P] bool), ``used`` the
    card-profiling signal reduced over kv heads."""
    if _kernel(q, impl):
        return _paged_attn_mod.paged_attention(q, k_pages, v_pages,
                                               page_table, page_lens)
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                   page_lens)


def lengths_to_page_lens(lengths, num_pages: int, page_tokens: int):
    """Dense layout helper: [B] total lengths -> [B, NP] rows per page."""
    starts = torch.arange(num_pages, device=lengths.device) * page_tokens
    return (lengths[:, None] - starts[None, :]).clamp(0, page_tokens).to(
        torch.int32)
