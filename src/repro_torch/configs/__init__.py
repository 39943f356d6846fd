"""Architecture configs + shape registry (port of ``repro.configs``).

Each assigned architecture has a module ``repro_torch.configs.<id>`` (dash
-> underscore) exporting ``CONFIG`` (exact assigned hyperparameters) and
``SMOKE`` (a reduced same-family config for CPU smoke tests).

``get_config(name)`` / ``get_smoke(name)`` resolve by arch id;
``SHAPES`` maps shape ids to (seq_len, global_batch, kind).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_topk: int = 0
    moe_capacity: float = 1.25
    # --- attention ----------------------------------------------------------
    sliding_window: int = 0        # >0: SWA (mixtral)
    rope_theta: float = 1e4
    # --- recurrent ----------------------------------------------------------
    ssm_state: int = 0
    block_pattern: Tuple[str, ...] = ()   # per-scan-group block sequence
    shared_attn_period: int = 0    # zamba: shared attn every N blocks
    # --- encoder-decoder ------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    # --- frontend stubs ---------------------------------------------------
    frontend: str = "none"         # none | audio | vision
    frontend_seq: int = 0          # frames / patches provided by input_specs
    frontend_dim: int = 0          # stub embedding width
    # --- numerics / features ----------------------------------------------
    dtype: Any = torch.bfloat16
    remat: bool = True
    tie_embeddings: bool = False
    subquadratic: bool = False     # may run long_500k
    atlas_kv: bool = True          # KV cache managed by the hybrid plane
    atlas_experts: bool = False    # expert weights managed by the plane
    # decode sparse-attention (Atlas runtime path showcase)
    sparse_topk_pages: int = 0     # >0: top-k paged sparse decode attention

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode | decode_long


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode_long"),
}

ARCHS = [
    "xlstm-350m", "codeqwen1.5-7b", "granite-20b", "llama3-8b", "yi-9b",
    "mixtral-8x7b", "kimi-k2-1t-a32b", "zamba2-1.2b", "seamless-m4t-medium",
    "paligemma-3b",
]

# pure full-attention archs skip long_500k (see DESIGN.md §Arch-applicability)
LONG_SKIP = {"codeqwen1.5-7b", "granite-20b", "yi-9b", "seamless-m4t-medium",
             "paligemma-3b"}


def _module(name: str):
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells flagged."""
    out = []
    for a in ARCHS:
        for sh in SHAPES.values():
            skipped = sh.name == "long_500k" and a in LONG_SKIP
            if skipped and not include_skipped:
                continue
            out.append((a, sh.name, skipped))
    return out
