"""Paged decode attention on the card: the wrapper of the hand-written
CUDA kernel ``csrc/paged_attention.cu`` (the port of the Pallas kernel
``repro.kernels.paged_attention.paged_attention``).

``q [B, H, Dh], k/v_pages [KVH, F, P, Dh], page_table/page_lens [B, NP]
int32 -> (out [B, H, Dh] in q's dtype, used [B, NP, P] bool)``, the card
signal already reduced over kv heads, as ``ops.paged_attention`` returns
it.  ``kernel_path`` picks one of the kernel's two paths from dtypes and
shapes alone, and raises outside both:

- ``"mma"``, the tensor cores (``mma.sync`` bf16, f32 accumulate): bf16 q
  and K/V, G = H/KVH up to 64, Dh a multiple of 16 up to 256, P up to 64;
- ``"cuda_core"``, f32 arithmetic on CUDA cores: f32 or mixed dtypes (TF32
  would miss the f32 tolerance), Dh a multiple of 8 but not of 16, or P
  from 65 to 128; G up to 8, Dh up to 256.

With fewer (sequence, kv head) pairs than the card has SMs the pages are
split over blocks (flash-decoding): on the tensor-core path the last block
of a pair combines the splits in the same launch, using per-pair counters
that the kernel leaves at 0 for the next call; on the CUDA-core path a
second kernel combines them.  The wrapper allocates that scratch.  CUDA
tensors only.
"""
from __future__ import annotations

import math

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP, MAX_HEAD_DIM, MAX_PAGE_ROWS = 8, 256, 128       # CUDA-core path
MMA_MAX_GROUP, MMA_MAX_PAGE_ROWS = 64, 64                  # tensor-core path
MMA_SMEM = 232448 - 1024     # dynamic shared memory a block may take
SM_SMEM = 233472             # shared memory of one SM (1 KB a block reserved)
launches = 0        # kernel launches since the last ops.reset_launch_counts()
launches_mma = 0    # ... of them on the tensor-core path
_counters: dict = {}    # device index -> int32 split counters, kept at 0


def kernel_path(q_dtype, kv_dtype, group: int, head_dim: int,
                page_rows: int) -> str:
    """``"mma"`` or ``"cuda_core"`` for these dtypes and shapes; raises
    ValueError where neither path takes them."""
    if q_dtype not in DTYPES or kv_dtype not in DTYPES:
        raise ValueError(f"paged_attention: q and k/v f32 or bf16, got "
                         f"{q_dtype}, {kv_dtype}")
    if (q_dtype == kv_dtype == torch.bfloat16 and head_dim % 16 == 0
            and 0 < head_dim <= MAX_HEAD_DIM and 1 <= group <= MMA_MAX_GROUP
            and 1 <= page_rows <= MMA_MAX_PAGE_ROWS):
        return "mma"
    if (1 <= group <= MAX_GROUP and head_dim % 8 == 0
            and 0 < head_dim <= MAX_HEAD_DIM
            and 1 <= page_rows <= MAX_PAGE_ROWS):
        return "cuda_core"
    raise ValueError(f"paged_attention: the kernel takes G <= "
                     f"{MMA_MAX_GROUP} for bf16 (Dh a multiple of 16, P <= "
                     f"{MMA_MAX_PAGE_ROWS}) and G <= {MAX_GROUP} otherwise, "
                     f"Dh a multiple of 8 up to {MAX_HEAD_DIM} and P <= "
                     f"{MAX_PAGE_ROWS}; got {q_dtype}/{kv_dtype}, G={group}, "
                     f"Dh={head_dim}, P={page_rows}")


def split_pages(pairs: int, num_pages: int, sms: int) -> tuple[int, int]:
    """(splits, pages per split) of the CUDA-core path: about one block per
    SM when the (sequence, kv head) pairs alone cannot fill the card's
    ``sms`` SMs."""
    if pairs >= sms or num_pages <= 1:
        return 1, max(num_pages, 1)
    want = min(num_pages, -(-sms // pairs))
    per = -(-num_pages // want)
    return -(-num_pages // per), per


def _mma_stage_bytes(m_tiles: int, teams: int, head_dim: int,
                     page_rows: int) -> int:
    """Shared memory of a tensor-core block's Q, 1 KB of slack to align
    the rings to the TMA's swizzle, and the rings (3 slots of one page's K
    or V a team), as the kernel lays them out."""
    k_dh = 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256
    p16 = -(-page_rows // 16) * 16
    return 16 * m_tiles * k_dh * 2 + 1024 + teams * 3 * p16 * k_dh * 2


def launch_plan(path: str, pairs: int, num_pages: int, sms: int,
                group: int, head_dim: int,
                page_rows: int) -> tuple[int, int, int, int]:
    """(splits, pages per split, m_tiles, teams) of one call.

    The CUDA-core path splits by ``split_pages``.  On the tensor-core path
    a warp takes 16 query heads (an m-tile) and a team of m_tiles warps
    walks its own pages.  When the (sequence, kv head) pairs fill the
    card's ``sms`` SMs a block is one team over all of a pair's pages, so
    several small blocks share an SM.  Otherwise a block holds up to four
    teams (at most 8 warps, within shared memory), and the pages split so
    that the blocks fill every SM once, one page or more a team: the
    long_500k sparse step (8 pairs x 64 pages, 132 SMs) gives 16 splits of
    4 pages, one page a warp with all its loads issued at once."""
    if path != "mma":
        return (*split_pages(pairs, num_pages, sms), 0, 0)
    m_tiles = -(-group // 16)
    if pairs >= sms or num_pages <= 1:
        return 1, max(num_pages, 1), m_tiles, 1
    teams = max(1, min(4, 8 // m_tiles))
    while teams > 1 and _mma_stage_bytes(m_tiles, teams, head_dim,
                                         page_rows) > MMA_SMEM:
        teams -= 1
    per_sm = SM_SMEM // (_mma_stage_bytes(m_tiles, teams, head_dim,
                                          page_rows) + 1024)
    want = max(1, min(-(-num_pages // teams), sms * per_sm // pairs))
    per = -(-num_pages // want)
    splits = -(-num_pages // per)
    return splits, per, m_tiles, teams if splits > 1 else 1


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """Per-pair counters for the in-kernel split combine: zeroed once, and
    left at 0 by every launch that uses them."""
    c = _counters.get(device.index)
    if c is None or c.numel() < n:
        c = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _counters[device.index] = c
    return c


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    page_lens: torch.Tensor):
    """CUDA paged attention; see the module docstring for the shapes."""
    global launches, launches_mma
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
    if (v_pages.dtype != k_pages.dtype or page_table.dtype != torch.int32
            or page_lens.dtype != torch.int32):
        raise ValueError(f"paged_attention: k and v of one dtype, tables "
                         f"int32, got {k_pages.dtype}, {v_pages.dtype}, "
                         f"{page_table.dtype}, {page_lens.dtype}")
    path = kernel_path(q.dtype, k_pages.dtype, G, Dh, P)
    if (k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16
            or (path == "mma" and q.data_ptr() % 16)):
        raise ValueError("paged_attention: k/v pages (and bf16 q) must be "
                         "16-byte aligned")
    out = torch.empty_like(q)
    used = torch.empty((B, NP, P), dtype=torch.bool, device=q.device)
    if B * H * Dh == 0 or NP == 0:
        return out.zero_(), used.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per, m_tiles, teams = launch_plan(path, B * KVH, NP, sms, G, Dh,
                                              P)
    n_part = B * KVH * splits * G if splits > 1 else 1
    m_part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    l_part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    acc_part = torch.empty((n_part * (Dh if splits > 1 else 1),),
                           dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(Dh)
    lib = _build.load_library()
    if path == "mma":
        counters = _split_counters(q.device, B * KVH)
        err = lib.repro_paged_attention_mma(
            dev, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), page_lens.data_ptr(), out.data_ptr(),
            used.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), counters.data_ptr(), B, KVH, G, Dh, F, P,
            NP, splits, per, m_tiles, teams, scale, _build.stream_ptr(dev))
    else:
        err = lib.repro_paged_attention(
            dev, q.data_ptr(), int(q.dtype == torch.bfloat16),
            k_pages.data_ptr(), v_pages.data_ptr(),
            int(k_pages.dtype == torch.bfloat16), page_table.data_ptr(),
            page_lens.data_ptr(), out.data_ptr(), used.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), B,
            KVH, G, Dh, F, P, NP, splits, per, scale, _build.stream_ptr(dev))
    _build.check(err, "paged_attention")
    launches += 1
    launches_mma += path == "mma"
    return out, used
