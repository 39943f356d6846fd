"""Page scoring on the card: the wrapper of the hand-written CUDA kernel
``csrc/page_scores.cu`` (the port of the Pallas kernel
``repro.kernels.topk_pages.page_scores``).

``q [B, H, Dh] (f32 or bf16), kmax/kmin [KVH, NP, Dh] f32 -> [B, KVH, NP]
f32`` with ``max_g sum_d max(q*kmax, q*kmin)`` over the GQA group of each
kv head (H = KVH * G).  CUDA tensors only; ``ops.page_scores`` sends CPU
tensors to ``ref.page_scores_ref``.
"""
from __future__ import annotations

import torch

from . import _build

MAX_GROUP, MAX_HEAD_DIM = 16, 256
launches = 0    # kernel launches since the last ops.reset_launch_counts()


def page_scores(q: torch.Tensor, kmax: torch.Tensor,
                kmin: torch.Tensor) -> torch.Tensor:
    """CUDA page scores.  q [B, H, Dh]; kmax/kmin [KVH, NP, Dh] f32."""
    global launches
    dev = _build.require_cuda("page_scores", q=q, kmax=kmax, kmin=kmin)
    if q.dim() != 3 or kmax.dim() != 3 or kmax.shape != kmin.shape:
        raise ValueError(f"page_scores: q [B, H, Dh] and kmax/kmin "
                         f"[KVH, NP, Dh], got {tuple(q.shape)}, "
                         f"{tuple(kmax.shape)}, {tuple(kmin.shape)}")
    B, H, Dh = q.shape
    KVH, NP, Dk = kmax.shape
    if Dk != Dh or H % KVH:
        raise ValueError(f"page_scores: head dims {Dh} vs {Dk}, {H} query "
                         f"heads over {KVH} kv heads")
    G = H // KVH
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            kmax.dtype != torch.float32 or kmin.dtype != torch.float32:
        raise ValueError(f"page_scores: q f32/bf16 and f32 summaries, got "
                         f"{q.dtype}, {kmax.dtype}, {kmin.dtype}")
    if G > MAX_GROUP or Dh % 8 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"page_scores: the kernel takes G <= {MAX_GROUP} "
                         f"and Dh a multiple of 8 up to {MAX_HEAD_DIM}, got "
                         f"G={G}, Dh={Dh}")
    if kmax.data_ptr() % 16 or kmin.data_ptr() % 16:
        raise ValueError("page_scores: kmax/kmin must be 16-byte aligned")
    out = torch.empty((B, KVH, NP), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    err = _build.load_library().repro_page_scores(
        dev, q.data_ptr(), int(q.dtype == torch.bfloat16), kmax.data_ptr(),
        kmin.data_ptr(), out.data_ptr(), B, KVH, G, NP, Dh,
        _build.stream_ptr(dev))
    _build.check(err, "page_scores")
    launches += 1
    return out
