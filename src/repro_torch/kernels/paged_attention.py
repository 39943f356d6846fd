"""Paged decode attention on the card: the wrapper of the hand-written
CUDA kernel ``csrc/paged_attention.cu`` (the port of the Pallas kernel
``repro.kernels.paged_attention.paged_attention``).

``q [B, H, Dh], k/v_pages [KVH, F, P, Dh], page_table/page_lens [B, NP]
int32 -> (out [B, H, Dh] in q's dtype, used [B, NP, P] bool)``, the card
signal already reduced over kv heads, as ``ops.paged_attention`` returns
it.  The kernel takes f32 or bf16, G = H/KVH up to 8, Dh a multiple of 8
up to 256 and P up to 128; it raises outside those shapes.  With fewer
(sequence, kv head) pairs than the card has SMs the pages are split over
blocks and a second kernel combines them (flash-decoding); the wrapper
allocates that scratch.  CUDA tensors only.
"""
from __future__ import annotations

import math

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP, MAX_HEAD_DIM, MAX_PAGE_ROWS = 8, 256, 128
launches = 0    # kernel launches since the last ops.reset_launch_counts()


def split_pages(pairs: int, num_pages: int, sms: int) -> tuple[int, int]:
    """(splits, pages per split): about one block per SM when the
    (sequence, kv head) pairs alone cannot fill the card's ``sms`` SMs."""
    if pairs >= sms or num_pages <= 1:
        return 1, max(num_pages, 1)
    want = min(num_pages, -(-sms // pairs))
    per = -(-num_pages // want)
    return -(-num_pages // per), per


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    page_lens: torch.Tensor):
    """CUDA paged attention; see the module docstring for the shapes."""
    global launches
    dev = _build.require_cuda("paged_attention", q=q, k_pages=k_pages,
                              v_pages=v_pages, page_table=page_table,
                              page_lens=page_lens)
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q [B, H, Dh], k/v [KVH, F, P, "
                         f"Dh], got {tuple(q.shape)}, {tuple(k_pages.shape)},"
                         f" {tuple(v_pages.shape)}")
    B, H, Dh = q.shape
    KVH, F, P, Dk = k_pages.shape
    if (page_table.dim() != 2 or page_table.shape[0] != B
            or page_lens.shape != page_table.shape):
        raise ValueError(f"paged_attention: page_table/page_lens [B, NP], "
                         f"got {tuple(page_table.shape)}, "
                         f"{tuple(page_lens.shape)}")
    NP = page_table.shape[1]
    if Dk != Dh or H % KVH:
        raise ValueError(f"paged_attention: head dims {Dh} vs {Dk}, {H} "
                         f"query heads over {KVH} kv heads")
    G = H // KVH
    if (q.dtype not in DTYPES or k_pages.dtype not in DTYPES
            or v_pages.dtype != k_pages.dtype
            or page_table.dtype != torch.int32
            or page_lens.dtype != torch.int32):
        raise ValueError(f"paged_attention: q and k/v f32 or bf16, tables "
                         f"int32, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}, {page_table.dtype}, "
                         f"{page_lens.dtype}")
    if G > MAX_GROUP or Dh % 8 or Dh > MAX_HEAD_DIM or P > MAX_PAGE_ROWS:
        raise ValueError(f"paged_attention: the kernel takes G <= "
                         f"{MAX_GROUP}, Dh a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and P <= {MAX_PAGE_ROWS}, got "
                         f"G={G}, Dh={Dh}, P={P}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: k/v pages must be 16-byte aligned")
    out = torch.empty_like(q)
    used = torch.empty((B, NP, P), dtype=torch.bool, device=q.device)
    if B * H * Dh == 0 or NP == 0:
        return out.zero_(), used.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = split_pages(B * KVH, NP, sms)
    n_part = B * KVH * splits * G if splits > 1 else 1
    m_part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    l_part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    acc_part = torch.empty((n_part * (Dh if splits > 1 else 1),),
                           dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(Dh)
    err = _build.load_library().repro_paged_attention(
        dev, q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), int(k_pages.dtype == torch.bfloat16),
        page_table.data_ptr(), page_lens.data_ptr(), out.data_ptr(),
        used.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        acc_part.data_ptr(), B, KVH, G, Dh, F, P, NP, splits, per,
        scale, _build.stream_ptr(dev))
    _build.check(err, "paged_attention")
    launches += 1
    return out, used
