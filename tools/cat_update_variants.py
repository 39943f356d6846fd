#!/usr/bin/env python
"""Time the port's CAT update kernel (``src/repro_torch/kernels/csrc/
cat_update.cu``) beside other designs of the same update, on one CUDA
card, at the hybrid plane's CAT and around it.

Each shape's candidates are checked bit for bit against
``ref.cat_update_ref``, then timed on the device (a sleep kernel holds the
stream while the host queues the calls, so the events time the calls back
to back; median of rounds), in turns: every candidate forward, then in
reverse order, and both medians are printed.  Each is timed twice: warm,
on one copy of the words, which then stay in the 50 MB L2 between calls,
and cold, cycling 4 copies, so that every call finds its words in device
memory; the share of the bound is the cold time's, as the bound counts
the words from device memory.  The candidates:

- ``port``: the one-launch kernel, as the wrapper launches it;
- ``port, 256 threads`` / ``port, 1024 threads`` / ``port, 16 KB
  chunks``: the same source with another block size or chunk;
- ``pipelined, ...``: the one-launch kernel made persistent, a ring of two
  chunk buffers a block (``tools/cat_update_variants.cu``);
- ``three steps``: the port's design before the one-launch kernel
  (``tools/cat_update_variants.cu``): a device copy, a scatter of global
  atomics, a count kernel;
- ``copy_ + fill_ (same bytes)``: not the update, but the bytes it must
  move, moved by two PyTorch passes (a copy of the words, a fill of a
  CAR-sized array): what the card's memory gives a plain stream here.

Run from the repo root on a machine with a card and ``nvcc``:

    python3 tools/cat_update_variants.py [--out build/cat_update_variants.json]
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
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import (cat_touch_sets, cat_words, cycler,  # noqa: E402
                        device_ms)
from repro_torch.kernels import _build, ref  # noqa: E402

SEED = 0
COPIES = 4
# edits of the port's source: (name, (old, new) text replacements)
EDITS = [
    ("port, 256 threads", [("kThreads = 512", "kThreads = 256")]),
    ("port, 1024 threads", [("kThreads = 512", "kThreads = 1024")]),
    ("port, 16 KB chunks", [("kChunkWords = 8192", "kChunkWords = 4096")])]
# the persistent design (tools/cat_update_variants.cu): (chunk words,
# blocks an SM)
PIPELINED = [(8192, 2), (4096, 3)]


def build_variants() -> dict:
    """Compile the edited copies of the port's source, all at once; return
    ctypes libraries by candidate name."""
    out = ROOT / "build" / "tools" / "cat_update"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "cat_update.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(EDITS):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = out / f"variant{i}.cu"
        cu.write_text(text)
        jobs[name] = (cu, out / f"libvariant{i}.so")
    jobs["designs"] = (Path(__file__).with_suffix(".cu"),
                         out / "libdesigns.so")
    procs = {name: subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (cu, so) in jobs.items()}
    libs = {}
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(jobs[name][1]))
        if name == "designs":
            lib.cuv_pipelined.argtypes = [P, P, P, P, I64, I32, I64, I32, I32,
                                          I32, P]
            lib.cuv_three_steps.argtypes = [P, P, P, P, I64, I32, I64, I32,
                                            P]
        else:
            lib.repro_cat_update.argtypes = [I32, P, P, P, P, P, I64, I32,
                                             I64, I32, P]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/cat_update_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cat_update_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    stream = lambda: _build.stream_ptr(0)  # noqa: E731

    def direct(lib, Pc):
        def run(bits, va):
            V, W = bits.shape
            out = torch.empty_like(bits)
            car = torch.empty((V,), dtype=torch.float32, device=dev)
            _build.check(lib.repro_cat_update(
                0, bits.data_ptr(), va.data_ptr(), out.data_ptr(),
                car.data_ptr(), None, V, W, va.shape[0], Pc, stream()),
                "variant")
            return out, car
        return run

    def three_steps(Pc):
        def run(bits, va):
            V, W = bits.shape
            out = torch.empty_like(bits)
            car = torch.empty((V,), dtype=torch.float32, device=dev)
            _build.check(libs["designs"].cuv_three_steps(
                bits.data_ptr(), va.data_ptr(), out.data_ptr(),
                car.data_ptr(), V, W, va.shape[0], Pc, stream()),
                "three steps")
            return out, car
        return run

    def pipelined(Pc, chunk_words, per_sm):
        def run(bits, va):
            V, W = bits.shape
            out = torch.empty_like(bits)
            car = torch.empty((V,), dtype=torch.float32, device=dev)
            _build.check(libs["designs"].cuv_pipelined(
                bits.data_ptr(), va.data_ptr(), out.data_ptr(),
                car.data_ptr(), V, W, va.shape[0], Pc, chunk_words, per_sm,
                stream()), "pipelined")
            return out, car
        return run

    def candidates(Pc):
        cands = {"port": direct(_build.load_library(), Pc)}
        for name, _ in EDITS:
            cands[name] = direct(libs[name], Pc)
        for cw, per_sm in PIPELINED:
            cands[f"pipelined, {cw // 256} KB chunks, {per_sm}/SM"] = \
                pipelined(Pc, cw, per_sm)
        cands["three steps"] = three_steps(Pc)
        return cands

    def reference(bits, va):
        """Not the update: the same bytes moved by two library passes, a
        copy of the words and a fill of a CAR-sized array."""
        out = torch.empty_like(bits)
        out.copy_(bits)
        car = torch.empty((bits.shape[0],), dtype=torch.float32, device=dev)
        car.fill_(0.5)
        return out, car

    V = 3_145_728
    shapes = [("hybrid CAT, R = 1,024", V, 8, 1024),
              ("R = 8,192", V, 8, 8192), ("R = 32,768", V, 8, 32_768),
              ("R = 65,536", V, 8, 65_536), ("R = 262,144", V, 8, 262_144),
              ("2 words a page (P = 40), R = 1,024", V // 2, 40, 1024),
              ("4,096 pages, R = 16,384", 4096, 8, 16_384),
              ("4,096 pages, R = 65,536", 4096, 8, 65_536)]
    floor = device_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"[floor] empty kernel back to back: {floor * 1e3:.3f} us [{card}]",
          flush=True)
    result = {"card": card, "floor_us": floor * 1e3, "shapes": []}
    for name, V_, Pc, R in shapes:
        copies = [cat_words(torch, g, V_, Pc) for _ in range(COPIES)]
        sets = cat_touch_sets(torch, g, V_, Pc, R)
        cands = candidates(Pc)
        want_b, want_c = ref.cat_update_ref(copies[0], sets[0], Pc)
        for cname, fn in cands.items():
            got_b, got_c = fn(copies[0], sets[0])
            if not (torch.equal(got_b, want_b) and torch.equal(
                    got_c.view(torch.int32), want_c.view(torch.int32))):
                print(f"[{name}] {cname}: disagrees with the plain version")
                return 1
        del got_b, got_c, want_b, want_c
        cands["copy_ + fill_ (same bytes)"] = reference
        order = list(cands)
        times = {(c, k): [] for c in order for k in ("warm", "cold")}
        # a discarded pass first: the first timing after the checks runs
        # slow
        device_ms(torch, lambda: cands[order[0]](copies[0], sets[0]))
        for c in order + order[::-1]:
            for kind, pool in (("warm", copies[:1]), ("cold", copies)):
                pb, pv = cycler(pool), cycler(sets)
                times[(c, kind)].append(device_ms(
                    torch, lambda: cands[c](pb(), pv())))
        W = copies[0].shape[1]
        bound_us = (8 * V_ * W + 4 * V_ + 4 * R) / 3.35e12 * 1e6
        print(f"[{name}] V={V_} P={Pc} W={W} R={R}: bound {bound_us:.3f} us "
              f"by bytes [{card}]", flush=True)
        row = {"shape": name, "pages": V_, "page_objs": Pc, "touches": R,
               "bound_us": bound_us, "us": {}}
        for c in order:
            w = [t * 1e3 for t in times[(c, "warm")]]
            k = [t * 1e3 for t in times[(c, "cold")]]
            print(f"[{name}]   {c:<34} warm {w[0]:8.3f} / {w[1]:8.3f} us, "
                  f"cold {k[0]:8.3f} / {k[1]:8.3f} us "
                  f"({100 * bound_us / statistics.mean(k):.1f}% of the bound "
                  f"cold)", flush=True)
            row["us"][c] = {"warm": w, "cold": k}
        result["shapes"].append(row)
        del copies, sets
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
