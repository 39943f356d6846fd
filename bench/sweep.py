"""Find the knee of an open-loop cell once: the highest offered rate at
which the backlog does not grow over a window.  One set-up, then one open
window a rate, each continuing the stream on the same engine.

    python3 -m bench.sweep --workload mcd-cl.open --seed 7 --seconds 8 \\
        --rates 40000,50000,60000

prints for each rate the latency median and p99, the queue wait's median
in the window's first and last quarter (a backlog that grows shows as the
second far above the first), and how late the last request was submitted.
The benchmark's runs never run it; the cell's rate is set from its
output by hand.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from bench import run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(bench_run.ROOT / "src"))
    from bench import store
    from bench import traffic as tr

    spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    cfg = bench_run.load_json(bench_run.BENCH / "configs"
                              / f"{cell['config']}.json")
    mix = bench_run.load_json(bench_run.BENCH / "traffic"
                              / f"{cell['traffic']}.json")
    rates = [float(r) for r in args.rates.split(",")]

    class Sweep(store.Run):
        def n_requests(self):
            warm = ((int(self.cfg["warm_ticks"]) + self.ecfg.evac_every)
                    * self.batch)
            self.arrivals = np.zeros(0)
            return warm + int(sum(1.2 * r * args.seconds + 1000
                                  for r in rates))

    run = Sweep(cfg, mix, args.seed, args.seconds, False, args.device)
    t0 = time.time()
    run.setup()
    print(f"[sweep] {args.workload}: set-up {time.time() - t0:.1f} s",
          flush=True)
    for i, rate in enumerate(rates):
        run.arrivals = tr.arrivals(dict(mix, rate_per_s=rate),
                                   args.seed + i + 1, args.seconds)
        run.served = []
        run.window()
        lat = run.latency_s
        q = run.queue_s
        n = q.size
        first, last = q[:n // 4], q[-(n // 4):]
        lag = float(q[-1]) if n else float("nan")
        print(f"[sweep] rate {rate:.0f}/s: {run.arrivals.size} requests, "
              f"{len(run.served)} submits, latency p50 "
              f"{np.nanpercentile(lat, 50) * 1e3:.2f} ms p99 "
              f"{np.nanpercentile(lat, 99) * 1e3:.2f} ms, queue p50 first "
              f"quarter {np.median(first) * 1e3:.2f} ms last quarter "
              f"{np.median(last) * 1e3:.2f} ms, last request submitted "
              f"{lag * 1e3:.1f} ms after its arrival, window "
              f"{run.window_s:.2f} s, misses "
              f"{run.window_stats['misses']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
