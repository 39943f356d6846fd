"""The control of the check that decides ``correct``: the reference put
in the program's place one precision down (bfloat16 rows for the f32
store), judged by the same comparison at the cell's own size.  It must
come out not correct on every seed.  The benchmark's runs never run it.

    python3 -m bench.control --workload mcd-cl.closed --seeds 1,2,3 --keys 2000000

prints, for each seed, the numbers compared beside their limits.
"""
from __future__ import annotations

import argparse
import sys
import time

from bench import run as bench_run


def readings(spec: dict, name: str, seed: int, n_keys: int, device: str,
             log=print) -> dict:
    """The control's readings for one seed: ``n_keys`` keys of the cell's
    stream (past its warm-up, as a window serves them) and a read-back of
    as many keys as a run reads back, each row the reference's in
    bfloat16."""
    import torch

    from bench import reference, store
    from bench import traffic as tr

    cell = next(w for w in spec["workloads"] if w["name"] == name)
    cfg = bench_run.load_json(bench_run.BENCH / "configs"
                              / f"{cell['config']}.json")
    mix = bench_run.load_json(bench_run.BENCH / "traffic"
                              / f"{cell['traffic']}.json")
    run = store.Run(cfg, mix, seed, 1.0, False, device)
    run.inputs()
    start = int(cfg["warm_ticks"]) * run.batch
    keys = run.keys[start:start + n_keys]
    if keys.shape[0] < n_keys:
        keys = tr.request_keys(cfg["keys"], run.pcfg.num_objs, seed,
                               start + n_keys, run.device)[start:]
    served = [(keys[a:a + run.batch],
               reference.control(run.data, keys[a:a + run.batch]))
              for a in range(0, keys.shape[0], run.batch)]
    back = tr.uniform_keys(seed, tr.SAMPLE, run.pcfg.num_objs, 0,
                           store.READBACK, run.device)
    got = reference.compare(run.data, served)
    rb = reference.compare(run.data, [(back, reference.control(run.data,
                                                               back))])
    out = {"rows_wrong": got["rows_wrong"],
           "max_abs_gap": max(got["max_abs_gap"], rb["max_abs_gap"]),
           "readback_wrong": rb["rows_wrong"], "rows": got["rows"]}
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--keys", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(bench_run.ROOT / "src"))
    spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    from bench import reference
    refused = True
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.time()
        r = readings(spec, args.workload, seed, args.keys, args.device)
        bad = [k for k, lim in reference.LIMITS.items()
               if k in r and r[k] > lim]
        refused &= bool(bad)
        print(f"[control] {args.workload} seed {seed}: {r} (limits "
              f"{reference.LIMITS}); fails {bad}; {time.time() - t0:.1f} s",
              flush=True)
    print(f"[control] refused on every seed: {refused}")
    return 0 if refused else 1


if __name__ == "__main__":
    sys.exit(main())
