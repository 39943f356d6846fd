#!/usr/bin/env python
"""Time the port's row-copy kernel (``src/repro_torch/kernels/csrc/
row_gather.cuh``) beside other designs of the same copy, on one CUDA card,
at the shapes the serving and model paths give it.

Each shape's candidates are checked bit for bit against
``ref.gather_rows_ref``, then timed on the device (a sleep kernel holds
the stream while the host queues the calls, so the events time the calls
back to back; median of rounds), in turns: every candidate forward, then
in reverse order, and both medians are printed.  The candidates:

- ``port``: ``gather_objects.gather_rows`` or ``compact.compact_pages`` at
  the plan ``gather_objects.launch_plan`` gives;
- ``port, hint flipped``: the same plan with the streaming hint flipped;
- ``port, 8 blocks/SM``: the tiles regime's grid capped at 8 blocks an SM
  rather than 4;
- ``port, struct args``: the port's body with its arguments in a struct,
  without ``__restrict__``; ``port, shfl``: the same with the row's index
  loaded by one lane of each warp and broadcast with ``__shfl_sync``;
  ``port, U=u``: the same with ``u`` loads in flight a thread;
- ``flat``: the port's first body; ``first redesign``: the rows and tiles
  regimes that replaced it first (both in ``tools/row_copy_variants.cu``);
- ``index_select`` (the library call) and the empty kernel
  (``torch.cuda._sleep(0)``).

Run from the repo root on a machine with a card and ``nvcc``:

    python3 tools/row_copy_variants.py [--out build/row_copy_variants.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, compact, gather_objects as gmod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SEED = 0


def build_variants() -> ctypes.CDLL:
    out = ROOT / "build" / "tools" / "librowcopyvariants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).with_suffix(".cu")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rcv_flat.argtypes = [P, I64, P, I64, P, I64, P]
    lib.rcv_first.argtypes = [P, I64, P, I64, P, I64, P]
    lib.rcv_port_v.argtypes = [I32, I32, I32, P, I64, P, I64, P, I64, I32,
                               I32, I32, P]
    return lib


def device_ms(fn, n: int, rounds: int) -> float:
    """Median device time of one call, in ms (as chip_smoke.py times)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def cycler(items):
    pos = [0]

    def nxt():
        pos[0] += 1
        return items[pos[0] % len(items)]
    return nxt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/row_copy_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_copy_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda", 0)
    lib = _build.load_library()
    var = build_variants()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    stream = lambda: _build.stream_ptr(0)  # noqa: E731

    def idx_sets(r, hi, p_masked, distinct=False, n=16):
        sets = []
        for _ in range(n):
            if distinct:
                i = torch.randperm(hi, generator=g, device=dev)[:r]
            else:
                i = torch.randint(0, hi, (r,), generator=g, device=dev)
            drop = torch.rand((r,), generator=g, device=dev) < p_masked
            sets.append(torch.where(drop, -1, i).to(torch.int32))
        return sets

    def new_out(pool, idx):
        return torch.empty((idx.shape[0], pool.shape[1]), dtype=pool.dtype,
                           device=dev)

    def plan_of(pool, idx):
        return gmod.launch_plan(idx.shape[0],
                                pool.shape[1] * pool.element_size())

    def plan_wpr(pool):
        return pool.shape[1] * pool.element_size() // 16

    def port(pool, flip=False, blocks_per_sm=None):
        def run(idx):
            out, plan = new_out(pool, idx), plan_of(pool, idx)
            if flip:
                plan = plan._replace(streaming=not plan.streaming)
            if blocks_per_sm is not None:
                plan = plan._replace(grid_x=min(-(-plan_wpr(pool) // plan.lanes),
                                                -(-132 * blocks_per_sm //
                                                  plan.grid_y)))
            _build.check(lib.repro_gather_rows(
                0, pool.data_ptr(), pool.shape[0], idx.data_ptr(),
                idx.shape[0], out.data_ptr(),
                pool.shape[1] * pool.element_size(), *plan.c_args(),
                stream()), "port")
            return out
        return run

    def port_v(pool, unroll, shfl=False):
        def run(idx):
            out, plan = new_out(pool, idx), plan_of(pool, idx)
            _build.check(var.rcv_port_v(
                unroll, int(shfl), int(plan.streaming), pool.data_ptr(),
                pool.shape[0],
                idx.data_ptr(), idx.shape[0], out.data_ptr(),
                pool.shape[1] * pool.element_size(), plan.lanes, plan.grid_x,
                plan.grid_y, stream()), "port_v")
            return out
        return run

    def other(fn, pool):
        def run(idx):
            out = new_out(pool, idx)
            _build.check(fn(pool.data_ptr(), pool.shape[0], idx.data_ptr(),
                            idx.shape[0], out.data_ptr(),
                            pool.shape[1] * pool.element_size(), stream()),
                         "variant")
            return out
        return run

    def small(pool, wrapper):
        return {"port": wrapper, "port, hint flipped": port(pool, True),
                "port, shfl": port_v(pool, 1, True),
                "port, struct args": port_v(pool, 1),
                "flat": other(var.rcv_flat, pool),
                "first redesign": other(var.rcv_first, pool)}

    def large(pool):
        return {"port": lambda i: gmod.gather_rows(pool, i),
                "port, hint flipped": port(pool, True),
                "port, 8 blocks/SM": port(pool, blocks_per_sm=8),
                "port, struct args": port_v(pool, 1),
                "port, shfl": port_v(pool, 1, True),
                "port, U=4": port_v(pool, 4), "port, U=8": port_v(pool, 8),
                "flat": other(var.rcv_flat, pool),
                "first redesign": other(var.rcv_first, pool)}

    # pools: 1 GiB of f32 object rows (the hybrid slab's 8,388,608 rows of
    # 32 f32, and its 1 KiB page view); 1 GiB of bf16 KV page rows (64
    # tokens x head_dim 128); 64 expert rows of kimi-k2's d_model x d_ff
    # bf16 (29.36 MB each)
    obj = torch.randn((8_388_608, 32), generator=g, device=dev)
    pages = obj.view(-1, 256)
    kv = torch.randn((65_536, 64 * 128), generator=g, device=dev,
                     dtype=torch.bfloat16)
    expert = torch.randn((64, 7168 * 2048), generator=g, device=dev,
                         dtype=torch.bfloat16)

    shapes = [
        ("1,024 x 128 B object rows, 50% masked", obj,
         idx_sets(1024, obj.shape[0], 0.5), 40, 5,
         small(obj, lambda i: gmod.gather_rows(obj, i))),
        ("32 x 128 B compact_pages slots, 25% masked", obj,
         idx_sets(32, obj.shape[0], 0.25), 40, 5,
         small(obj, lambda i: compact.compact_pages(
             obj, i, page_objs=8).view(32, -1))),
        ("1,032 x 1 KiB page rows, 50% masked", pages,
         idx_sets(1032, pages.shape[0], 0.5), 40, 5,
         small(pages, lambda i: gmod.gather_rows(pages, i))),
        ("32 x 16 KiB KV page rows", kv, idx_sets(32, kv.shape[0], 0.0), 40,
         5, large(kv)),
        ("256 x 16 KiB KV page rows", kv, idx_sets(256, kv.shape[0], 0.0), 40,
         5, large(kv)),
        ("8 x 29.36 MB expert rows", expert,
         idx_sets(8, expert.shape[0], 0.0, distinct=True, n=4), 10, 3,
         large(expert)),
    ]
    floor = device_ms(lambda: torch.cuda._sleep(0), 40, 5)
    print(f"[floor] empty kernel back to back: {floor * 1e3:.3f} us [{card}]",
          flush=True)
    result = {"card": card, "floor_us": floor * 1e3, "shapes": []}
    for name, pool, sets, n, rounds, cands in shapes:
        want = ref.gather_rows_ref(pool, sets[0])
        for cname, fn in cands.items():
            got = fn(sets[0])
            if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
                print(f"[{name}] {cname}: disagrees with the plain version")
                return 1
        del got, want
        cands = dict(cands)
        clamped = [s.clamp_min(0).long() for s in sets]
        pick_c = cycler(clamped)
        cands["index_select"] = lambda _i: pool.index_select(0, pick_c())
        times = {c: [] for c in cands}
        order = list(cands)
        # a discarded pass first: the first timing after the checks runs
        # slow
        device_ms(lambda: cands[order[0]](sets[0]), n, rounds)
        for c in order + order[::-1]:
            pick = cycler(sets)
            times[c].append(device_ms(lambda: cands[c](pick()), n, rounds))
        rb = pool.shape[1] * pool.element_size()
        valid = sum(int((s >= 0).sum()) for s in sets) / len(sets)
        bound_us = (valid * rb + sets[0].shape[0] * (rb + 4)) / 3.35e12 * 1e6
        plan = plan_of(pool, sets[0])
        print(f"[{name}] bound {bound_us:.3f} us by bytes; plan {plan} "
              f"[{card}]")
        for c in order:
            a, b = (t * 1e3 for t in times[c])
            print(f"[{name}]   {c:<18} {a:9.3f} / {b:9.3f} us", flush=True)
        result["shapes"].append({"shape": name, "bound_us": bound_us,
                                 "us": {c: [t * 1e3 for t in times[c]]
                                        for c in order}})
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
