"""Serving launcher: batched far-memory KV serving through the hybrid plane
on the card (PyTorch port of ``repro.launch.serve``).

  # far-memory KV store under the hybrid plane, on the GPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode kv \
      --plane hybrid --workload mcd_cl --steps 200

  # the same at a small size on the CPU (plain PyTorch kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --objects 512 --device cpu

``--mode lm`` (decoding through the plane-managed KV cache) waits for the
model slice of the port and raises.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.layout import PlaneConfig
from ..data import kvworkload
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
        raise NotImplementedError("--mode lm: the model slice of the port "
                                  "is not ported yet")
    serve_kv(args)


if __name__ == "__main__":
    main()
