"""Serving launcher: batched far-memory KV serving through the hybrid plane
on the card (PyTorch port of ``repro.launch.serve``).

  # far-memory KV store under the hybrid plane, on the GPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode kv \
      --plane hybrid --workload mcd_cl --steps 200

  # the same at a small size on the CPU (plain PyTorch kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --objects 512 --device cpu

  # LM decode with the plane-managed KV cache (smoke config, f32):
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch llama3-8b --tokens 32 --batch 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs as cfgs
from ..core.layout import PlaneConfig
from ..data import kvworkload
from ..models import api
from ..serving.engine import Engine, EngineConfig


def kv_plane_config(objects: int, local: float, **kw) -> PlaneConfig:
    """The launcher's KV-store plane: 32-wide f32 rows, 8 rows per page,
    a virtual page space of 3x the data pages, frames for ``local`` of the
    data pages (at least 8), and a readahead of 2 pages."""
    data_pages = -(-objects // 8)
    return PlaneConfig(num_objs=objects, obj_dim=32, page_objs=8,
                       num_frames=max(int(data_pages * local), 8),
                       num_vpages=3 * data_pages, readahead=2, **kw)


def kv_data(objects: int, seed: int) -> np.ndarray:
    """The store's rows: uniform random f32 from ``seed`` (``[objects, 32]``).
    Random rather than ``arange``: above 2**24 an f32 ``arange`` row is no
    longer exact, so a misplaced row could compare equal."""
    return np.random.default_rng(seed).random((objects, 32), np.float32)


def serve_kv(args):
    pcfg = kv_plane_config(args.objects, args.local)
    data = kv_data(args.objects, args.seed)
    eng = Engine(EngineConfig(plane=args.plane, batch=args.batch), pcfg,
                 data, device=args.device)
    wl = kvworkload.WORKLOADS[args.workload](args.objects, args.batch,
                                             args.steps, seed=0)
    rep = eng.run(wl, offered_interarrival_s=args.interarrival)
    print(f"[serve:kv] plane={args.plane} workload={args.workload} "
          f"local={args.local:.0%} device={eng.device}")
    print(f"  latency: {rep['latency']}")
    print(f"  stats:   {rep['stats']}")
    print(f"  paging fraction: {rep['paging_fraction']:.2f}")


def serve_lm(args):
    """Greedy decode of ``--tokens`` tokens for ``--batch`` sequences with
    the smoke config of ``--arch`` in f32, random weights from seed 0."""
    cfg = dataclasses.replace(cfgs.get_smoke(args.arch), dtype=torch.float32)
    shape = cfgs.ShapeConfig("serve", 1024, args.batch, "decode")
    params = api.init_params(cfg, seed=0, device=args.device)
    state = api.init_decode_state(cfg, shape, device=args.device)
    dev = state.lengths.device
    step = api.decode_step(cfg, shape)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (args.batch,), generator=g, device=dev,
                        dtype=torch.int32)
    state, logits = step(params, state, tok)            # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    toks = []
    for _ in range(args.tokens):
        tok = (logits.argmax(dim=-1) % cfg.vocab).to(torch.int32)
        state, logits = step(params, state, tok)
        toks.append(tok)
    sample = [int(t[0]) for t in toks[:16]]             # syncs the device
    dt = time.time() - t0
    print(f"[serve:lm] arch={args.arch} batch={args.batch} "
          f"decoded {args.tokens} tokens in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s) device={dev}")
    print(f"  sample continuation: {sample}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["kv", "lm"], default="kv")
    p.add_argument("--plane", default="hybrid",
                   choices=["hybrid", "paging", "object"])
    p.add_argument("--workload", default="mcd_cl",
                   choices=list(kvworkload.WORKLOADS))
    p.add_argument("--objects", type=int, default=4096)
    p.add_argument("--local", type=float, default=0.25)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--interarrival", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--tokens", type=int, default=32)
    args = p.parse_args(argv)
    if args.mode == "lm":
        serve_lm(args)
    else:
        serve_kv(args)


if __name__ == "__main__":
    main()
