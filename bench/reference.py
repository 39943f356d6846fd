"""The plain reference of the key-value store, and the comparison that
decides ``correct``.

A GET of key ``k`` returns row ``k`` of the data the benchmark made from
the seed: the reference indexes that tensor and nothing else.  It reads
no state of the program; the rows the program served are what it judges.
The comparison is exact (the store copies rows and never computes on
them), so every limit is 0.
"""
from __future__ import annotations

import torch

LIMITS = {"rows_wrong": 0, "max_abs_gap": 0.0, "readback_wrong": 0,
          "missing": 0}


def expected(data: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The rows a GET of ``keys`` must return."""
    return data.index_select(0, keys.to(torch.int64))


def control(data: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The reference one precision down (bfloat16 for the f32 store): the
    control that the comparison has to refuse."""
    return expected(data, keys).to(torch.bfloat16).to(data.dtype)


def compare(data: torch.Tensor, served, block_rows: int = 1 << 20) -> dict:
    """Judge ``served``, a list of ``(keys [n], rows [n, D])``: how many
    rows differ from the reference in any element, the widest gap, and
    how many rows were judged.  Works through blocks of about
    ``block_rows`` rows."""
    wrong, gap, n = 0, 0.0, 0
    i = 0
    while i < len(served):
        keys, rows, size = [], [], 0
        while i < len(served) and (size == 0 or size < block_rows):
            k, r = served[i]
            keys.append(k)
            rows.append(r)
            size += k.shape[0]
            i += 1
        got = torch.cat(rows)
        ref = expected(data, torch.cat(keys))
        diff = got != ref
        wrong += int(diff.any(dim=1).sum())
        if size:
            gap = max(gap, float((got.to(torch.float64)
                                  - ref.to(torch.float64)).abs().max()))
        n += size
    return {"rows": n, "rows_wrong": wrong, "max_abs_gap": gap}
