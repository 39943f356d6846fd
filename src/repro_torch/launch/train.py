"""Training launcher (port of ``repro.launch.train``): the end-to-end
entry point over the orchestrator.

Runs any ``--arch`` (full or smoke config) on the card, or on the CPU with
``--device cpu``: deterministic step-indexed data, AdamW (Adafactor for
kimi), gradient accumulation, async fault-tolerant checkpointing,
straggler accounting, restart and resume.  Like JAX's launcher it trains
in f32.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

  # a failure drill on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 24 --batch 2 --seq 32 --ckpt-every 8 --fail-at 11 \
      --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .. import configs as cfgs
from ..core.state import resolve_device
from ..data.synthetic import DataConfig, batch_for_step
from ..models import api
from ..optim import accumulated_value_and_grad, get_optimizer
from ..optim.optimizers import cosine_schedule
from ..runtime.orchestrator import (FailureInjector, Orchestrator,
                                    OrchestratorConfig)
from ..tree import leaves


def build(cfg, opt, accum: int = 1):
    """The step over the state (params, opt_state, step): the batch (numpy
    or tensors) goes to the state's device, the loss and gradients over
    ``accum`` micro-batches, one optimizer update in place."""
    vg = accumulated_value_and_grad(api.loss(cfg), accum)

    def train_step(state, batch):
        params, opt_state, step = state
        batch = {k: torch.as_tensor(v).to(step.device)
                 for k, v in batch.items()}
        loss, grads = vg(params, batch)
        del batch
        params, opt_state, gnorm = opt.update(grads, opt_state, params, step)
        return (params, opt_state, step + 1), {"loss": loss, "gnorm": gnorm}

    return train_step


def frontend_inputs(cfg, seq: int) -> dict:
    """The stub frontend inputs ``batch_for_step`` draws for ``cfg``:
    encoder frames (``max(seq // 4, 8)`` of them) or vision patches."""
    frontend = {}
    if cfg.family == "encdec":
        frontend["frames"] = ((max(seq // 4, 8), cfg.d_model), np.float32)
    if cfg.frontend == "vision":
        frontend["patches"] = ((cfg.frontend_seq, cfg.frontend_dim),
                               np.float32)
    return frontend


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced same-family config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--fail-at", type=int, nargs="*", default=[],
                   help="inject node failures at these steps (drill)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfgs.get_smoke(args.arch) if args.smoke else cfgs.get_config(
        args.arch)
    cfg = cfg.scaled(dtype=torch.float32)
    opt_name = "adafactor" if args.arch.startswith("kimi") else "adamw"
    opt = get_optimizer(opt_name, lr=cosine_schedule(args.lr, 20, args.steps))

    params = api.init_params(cfg, seed=0, device=dev)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"opt={opt_name} device={dev}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    frontend = frontend_inputs(cfg, args.seq)

    def batch_fn(step):
        return batch_for_step(dcfg, step, frontend=frontend or None)

    step_fn = build(cfg, opt, args.accum)
    losses = []

    def logging_step(state, batch):
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        step = int(state[2])
        if step % args.log_every == 0:
            tok_s = args.batch * args.seq / (time.time() - t0)
            print(f"  step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} tok/s {tok_s:,.0f}",
                  flush=True)
        return state, metrics

    orch = Orchestrator(
        OrchestratorConfig(ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every),
        logging_step, batch_fn,
        injector=FailureInjector(args.fail_at))
    init_state = (params, opt.init(params),
                  torch.zeros((), dtype=torch.int32, device=dev))
    state = orch.run(init_state, args.steps)
    print(f"[train] done: steps={orch.metrics['steps']} "
          f"restarts={orch.metrics['restarts']} "
          f"stragglers={orch.metrics['stragglers']} "
          f"final_loss={losses[-1]:.4f}" if losses else "[train] done")
    return state


if __name__ == "__main__":
    main()
