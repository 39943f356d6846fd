"""The operations and bytes of one decode step of a decoder, from its
``model`` block (``ArchConfig`` fields by name) and what the step did.

General over the decoders a decode cell can run: dense layers, grouped
KV heads, and sparse experts counted by the experts a token activates.
The step's data-dependent part (the K/V rows attention read, the pages
the plane fetched) comes in as counts; everything else follows from the
shapes.  Model FLOPs count the products a step must make (two per
multiply-add): the projections, the feed-forward, the head, and attention
over the rows attended.  Bytes count what a step must move once: every
weight (the embedding's rows for the batch alone), every page summary
``page_scores`` reads, the attended K/V rows, and each fetched page read
from the far tier and written to a frame.
"""
from __future__ import annotations

import dataclasses

import torch

from . import lm_inputs

SUMMARY_BYTES = 4           # the plane's page summaries are float32


@dataclasses.dataclass(frozen=True)
class StepCounts:
    attended_rows: float    # K/V rows attended in a step, over all layers
    fetched_pages: float    # pages fetched in a step, over all layers
    summary_pages: int      # pages a layer's page_scores reads
    page_tokens: int
    batch: int = 1


def _elt(m: dict) -> int:
    return torch.empty((), dtype=m["dtype"]).element_size()


def layer_params(m: dict) -> dict:
    """One layer's weights a token uses: attention, and the feed-forward
    (dense, or the router and the ``topk`` experts a token activates)."""
    d, H, KVH, hd, ff = m["d"], m["H"], m["KVH"], m["hd"], m["ff"]
    attn = d * (H + 2 * KVH) * hd + H * hd * d
    if m["experts"]:
        mlp = d * m["experts"] + m["topk"] * 3 * d * ff
    else:
        mlp = 3 * d * ff
    return {"attn": attn, "mlp": mlp, "norms": 2 * d}


def step_flops(model: dict, c: StepCounts) -> float:
    m = lm_inputs.dims(model)
    p = layer_params(m)
    weights = m["L"] * (p["attn"] + p["mlp"]) + m["d"] * m["vp"]
    attention = 4 * m["H"] * m["hd"] * c.attended_rows
    return 2.0 * c.batch * weights + attention


def step_bytes(model: dict, c: StepCounts) -> float:
    m = lm_inputs.dims(model)
    p = layer_params(m)
    e = _elt(m)
    KVH, hd = m["KVH"], m["hd"]
    if m["experts"]:
        # the router is float32; the experts of ``batch`` tokens, at most
        # all of them
        d, ff = m["d"], m["ff"]
        n = min(m["experts"], c.batch * m["topk"])
        layer = (p["attn"] + p["norms"]) * e + d * m["experts"] * 4 \
            + n * 3 * d * ff * e
    else:
        layer = (p["attn"] + p["mlp"] + p["norms"]) * e
    weights = m["L"] * layer + (m["d"] * m["vp"] + m["d"]
                                + c.batch * m["d"]) * e
    summaries = m["L"] * 2 * KVH * c.summary_pages * hd * SUMMARY_BYTES
    rows = c.attended_rows * 2 * KVH * hd * e
    fetched = c.fetched_pages * 2 * KVH * c.page_tokens * hd * e * 2
    return float(weights + summaries + rows + fetched)
