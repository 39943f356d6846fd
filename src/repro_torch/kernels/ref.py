"""Plain PyTorch versions of the kernels on the hybrid plane's and the KV
plane's paths.

Each ``<name>_ref`` has the semantics of the JAX package's Pallas kernel of
the same name (``repro.kernels``).  The CPU tests use them, the dispatch in
``ops`` takes them for CPU tensors, and the chip smoke test holds each CUDA
kernel against them on the card.  ``paged_attention_ref`` is the one with
matrix products (``einsum`` in f32): on the card they run in full f32 only
with TF32 off, which the chip smoke test sets.
"""
from __future__ import annotations

import torch


def gather_rows_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool [N, D], idx [R] int32 -> [R, D]; a negative index yields a zero
    row."""
    rows = pool[idx.clamp_min(0)]
    return torch.where((idx >= 0)[:, None], rows, torch.zeros_like(rows))


def gather_rows_into_ref(dst: torch.Tensor, dst_idx: torch.Tensor,
                         pool: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """``dst[dst_idx] = gather_rows_ref(pool, idx)``, in place; returns
    ``dst``."""
    dst[dst_idx.long()] = gather_rows_ref(pool, idx)
    return dst


def _last_wins(idx: torch.Tensor) -> torch.Tensor:
    """bool [N]: the last of the entries of ``idx`` that share a target
    (JAX on the CPU applies duplicate scatter writes in order)."""
    i = torch.arange(idx.shape[0], device=idx.device)
    same = idx[None, :] == idx[:, None]
    return torch.where(same, i[None, :], -1).amax(dim=1) == i


def scatter_rows_ref(pool: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``pool`` with ``rows[i]`` written to row ``idx[i]`` where ``idx[i] >=
    0`` (those distinct); a new tensor.  As in JAX a negative entry writes
    row 0's old value back to row 0, after any earlier write there."""
    safe = idx.clamp_min(0).long()
    val = torch.where((idx >= 0)[:, None], rows.to(pool.dtype), pool[safe])
    out = pool.clone()
    last = _last_wins(safe)
    out[safe[last]] = val[last]
    return out


def compact_rows_ref(frames: torch.Tensor, src: torch.Tensor,
                     dst_page: torch.Tensor, dst_rows=None) -> torch.Tensor:
    """Destination pages assembled from scattered source rows; a new
    tensor.  frames [F, P, D]; src [M, P] int32 flat row (frame*P + slot)
    per destination slot, -1 keeps the slot; dst_page [M] int32
    destination frame, -1 writes frame 0's old page back (after any earlier
    write there), as in JAX; ``dst_rows`` unused (JAX's API symmetry)."""
    F, P, D = frames.shape
    gathered = frames.reshape(F * P, D)[src.clamp_min(0).long()]
    tgt = dst_page.clamp_min(0).long()
    keep = frames[tgt]
    page = torch.where((src >= 0)[..., None], gathered, keep)
    page = torch.where((dst_page >= 0)[:, None, None], page, keep)
    out = frames.clone()
    last = _last_wins(tgt)
    out[tgt[last]] = page[last]
    return out


def compact_pages_ref(pool: torch.Tensor, plan: torch.Tensor,
                      page_objs: int) -> torch.Tensor:
    """pool [N, D], plan [M*P] flat row ids (-1 = zero slot) -> [M, P, D]."""
    M = plan.shape[0] // page_objs
    return gather_rows_ref(pool, plan).reshape(M, page_objs, pool.shape[-1])


def cat_decay_ref(cat: torch.Tensor, car_ema: torch.Tensor,
                  alloc: torch.Tensor, decay: float) -> torch.Tensor:
    """Epoch CAR EMA: cat [V, P] bool (or 0/1 ints), car_ema [V] f32,
    alloc [V] int32 -> ``f32(decay)*ema + f32(1-decay)*popcount/max(alloc,1)``
    in the f32 operation order of ``repro.kernels.ref.cat_decay_ref``."""
    cnt = cat.to(torch.float32).sum(dim=1)
    car = cnt / alloc.clamp_min(1).to(torch.float32)
    d = torch.full((), decay, dtype=torch.float32, device=car.device)
    # 1 - decay in Python double, then rounded to f32 (jnp.float32(1 - d))
    e = torch.full((), 1.0 - decay, dtype=torch.float32, device=car.device)
    return d * car_ema + e * car


# --------------------------------------------------------------------------
# the KV serve plane's kernels (kvplane)
# --------------------------------------------------------------------------

def page_scores_ref(q: torch.Tensor, kmax: torch.Tensor,
                    kmin: torch.Tensor) -> torch.Tensor:
    """Quest-style page upper bounds against far-resident summaries.

    q [B, H, Dh] (any float dtype, taken in f32); kmax/kmin [KVH, NP, Dh]
    f32 -> [B, KVH, NP] f32 = ``max_g sum_d max(q*kmax, q*kmin)``.  NaN
    propagates through both maxima as in ``jnp.maximum``: an unwritten
    page (kmax -inf, kmin +inf) scores NaN where some ``q_d`` is 0, and
    the caller masks it."""
    B, H, Dh = q.shape
    KVH = kmax.shape[0]
    qg = q.reshape(B, KVH, H // KVH, Dh).to(torch.float32)
    hi = qg[:, :, :, None, :] * kmax.to(torch.float32)[None, :, None]
    lo = qg[:, :, :, None, :] * kmin.to(torch.float32)[None, :, None]
    return torch.maximum(hi, lo).sum(-1).amax(dim=2)


def _inv_sqrt(dh: int, device) -> torch.Tensor:
    """``1 / sqrt(f32(Dh))`` in f32, as the JAX references scale scores."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.sqrt(torch.full((), dh, dtype=torch.float32,
                                       device=device))


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        page_lens: torch.Tensor):
    """GQA decode attention through a page table.

    q [B, H, Dh]; k/v_pages [KVH, F, P, Dh]; page_table [B, NP] int32
    (frame per column, -1 unused); page_lens [B, NP] int32 (valid rows per
    column) -> (out [B, H, Dh] in q's dtype, used [B, NP, P] bool).

    Softmax in f32 over the valid rows of each referenced frame; ``used``
    marks a row whose weight exceeds its page's mean weight (``w*P >
    mass``) for any query head.  A sequence with no valid row gives 0 and
    no used row, as the Pallas kernel does (it clamps the softmax sum at
    1e-30); ``repro.kernels.ref.paged_attention_ref`` gives NaN there."""
    B, H, Dh = q.shape
    KVH, F, P, _ = k_pages.shape
    NP = page_table.shape[1]
    G = H // KVH
    safe = page_table.clamp_min(0).long()
    k = k_pages[:, safe].to(torch.float32)               # [KVH, B, NP, P, Dh]
    v = v_pages[:, safe].to(torch.float32)
    k = k.permute(1, 0, 2, 3, 4).reshape(B, KVH, NP * P, Dh)
    v = v.permute(1, 0, 2, 3, 4).reshape(B, KVH, NP * P, Dh)
    qg = q.reshape(B, KVH, G, Dh).to(torch.float32)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * _inv_sqrt(Dh, q.device)
    row = torch.arange(P, device=q.device).repeat(NP)
    valid = ((row[None] < page_lens.repeat_interleave(P, dim=1))
             & (page_table >= 0).repeat_interleave(P, dim=1))  # [B, NP*P]
    vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, -torch.inf)
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    e = torch.where(vmask, torch.exp(scores - m), torch.zeros_like(scores))
    tot = e.sum(-1, keepdim=True)
    w = torch.where(tot > 0, e / tot, torch.zeros_like(e))
    out = torch.einsum("bkgs,bksd->bkgd", w, v)
    wp = w.reshape(B, KVH, G, NP, P)
    mass = wp.sum(-1, keepdim=True)
    used = (wp * P > mass).any(dim=2).any(dim=1) & valid.reshape(B, NP, P)
    return out.reshape(B, H, Dh).to(q.dtype), used


_M32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 tensors holding uint32 values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def cat_update_ref(cat_bits: torch.Tensor, vaddrs: torch.Tensor,
                   page_objs: int):
    """Set the card bits of touched vaddrs in a packed bitmap.

    cat_bits [V, W] int32 holding the uint32 words of the JAX version
    (W = ceil(page_objs/32)); vaddrs [R] int32, negative = skip.  Returns
    (bits [V, W] int32, car [V] f32 = popcount/page_objs).  Duplicate
    touches OR together.  The bit math runs in int64 (PyTorch has no
    uint32 shifts on the CPU).  A vaddr past the last page is dropped, as
    the JAX scatter drops it."""
    V, W = cat_bits.shape
    va = vaddrs.to(torch.int64)
    valid = (va >= 0) & (va < V * page_objs)   # out of range: dropped
    slot = va % page_objs
    pos = torch.where(valid, (va // page_objs) * W + slot // 32, V * W)
    # one flag per (word, bit): every touch writes True, so duplicates agree
    flags = torch.zeros(((V * W + 1) * 32,), dtype=torch.bool,
                        device=cat_bits.device)
    flags[pos * 32 + slot % 32] = True
    shifts = torch.arange(32, dtype=torch.int64, device=cat_bits.device)
    new = (flags.view(V * W + 1, 32)[:V * W].to(torch.int64)
           << shifts).sum(-1).view(V, W)
    bits = (cat_bits.to(torch.int64) & _M32) | new
    car = (_popcount32(bits).sum(dim=1).to(torch.float32)
           / torch.full((), page_objs, dtype=torch.float32,
                        device=cat_bits.device))
    # the uint32 words back into int32 with the same bits
    return torch.where(bits > 0x7FFFFFFF, bits - (1 << 32), bits).to(
        torch.int32), car
