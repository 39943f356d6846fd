"""The readings that set a decode check's limits, for any kit that has a
control (``CONTROL``) and faults (``FAULTS``): the program's on a dozen
seeds or more (the lower readings); the control's, the kit's reference in
a lower precision put in the program's place and judged by the same
comparison, on three or more (the upper readings; the dense kit's:
float8 e4m3); and the program's with a fault of the kit's planted, on
three or more each.  Each seed is a run of the cell at its own size with
a short window; the control reads the same steps.  The benchmark's runs
never run it.

    python3 -m bench.lm_control --workload yi-9b-200k.long \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 1,2,3 \\
        --faults kmax_only,marks_none,psf_flipped --fault-seeds 13,14,15 \\
        --seconds 3

prints each run's readings beside the limits, then the largest program
reading, the smallest control reading and each fault's smallest reading
of each number.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

from bench import run as bench_run


def readings(spec: dict, name: str, seed: int, seconds: float, device: str,
             control: bool, log=print, fault: str | None = None) -> dict:
    """One run of cell ``name`` (set-up, a window of ``seconds``, the
    check), with the kit's ``fault`` planted if given; the program's
    readings and, with ``control``, the control's."""
    import torch

    from bench import decode
    cell, cfg, mix = bench_run.cell_files(spec, name)
    run = decode.Run(cfg, mix, seed, seconds, False, torch.device(device),
                     log=log)
    if control and not getattr(run.kit_mod, "CONTROL", False):
        raise ValueError(f"the kit {run.kit_mod.__name__} has no control")
    faults = getattr(run.kit_mod, "FAULTS", {})
    if fault and fault not in faults:
        raise ValueError(f"the kit {run.kit_mod.__name__} has no fault "
                         f"{fault!r} (it has {sorted(faults)})")
    run.control = control
    planted = (decode.patched(*faults[fault]) if fault
               else contextlib.nullcontext())
    with planted:
        run.setup()
        run.window()
    run.check()
    out = {"program": run.readings["program"], "steps": run.steps,
           "correct": run.correct, "after_warm": run.after_warm,
           "reference_s": run.reference_s}
    if control:
        out["control"] = run.readings["control"]
    del run
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _seeds(text: str) -> list:
    return [int(x) for x in text.split(",")] if text else []


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(bench_run.ROOT / "src"))
    spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    from bench import decode
    cfg = bench_run.cell_files(spec, args.workload)[1]
    LIMITS = decode.kit_of(cfg).LIMITS
    ctl_seeds = set(_seeds(args.control_seeds))
    seeds = _seeds(args.seeds)
    faults = [f for f in args.faults.split(",") if f]
    lower = dict.fromkeys(LIMITS, 0.0)
    upper = {k: dict.fromkeys(LIMITS, float("inf"))
             for k in ["control"] + faults}
    refused = {k: True for k in upper}
    runs = [(s, None) for s in seeds + sorted(ctl_seeds - set(seeds))]
    runs += [(s, f) for f in faults for s in _seeds(args.fault_seeds)]
    for seed, fault in runs:
        t0 = time.time()
        r = readings(spec, args.workload, seed, args.seconds, args.device,
                     fault is None and seed in ctl_seeds,
                     log=lambda *a: None, fault=fault)
        got = {}
        if fault is None and seed in seeds:
            got["program"] = r["program"]
            for k in LIMITS:
                lower[k] = max(lower[k], r["program"][k])
        if fault is not None:
            got[fault] = r["program"]
        if "control" in r:
            got["control"] = r["control"]
        for who, g in got.items():
            if who in upper:
                for k in LIMITS:
                    upper[who][k] = min(upper[who][k], g[k])
                refused[who] &= any(g[k] > LIMITS[k] for k in LIMITS)
        print(f"[control] {args.workload} seed {seed}"
              f"{' fault ' + fault if fault else ''}: {r['steps']} steps, "
              f"after set-up {r['after_warm']}, reference "
              f"{r['reference_s']:.1f} s; "
              f"{got}; correct {r['correct']}; limits {LIMITS}; "
              f"{time.time() - t0:.1f} s", flush=True)
    print(f"[control] lower (program, largest of {len(seeds)} seeds): "
          f"{lower}", flush=True)
    for who, u in upper.items():
        print(f"[control] upper ({who}, smallest): {u}; fails a limit on "
              f"every seed: {refused[who]}", flush=True)
    return 0 if all(refused.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
