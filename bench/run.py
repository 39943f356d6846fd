"""Run one cell of the benchmark once and print its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card.  The cell, its
configuration (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<traffic>.json``) and its metrics (one reader each,
``bench/metrics/<metric>.py``) are found by name from ``BENCHMARK.json``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the traced segment's busy and window
seconds and a breakdown.  The numbers that decide ``correct`` are printed
with their limits as the last lines of standard error and, under
``checks``, last in the result line.  Without a card, or with fewer cards
than the cell asks for, it prints no result and exits non-zero.
"""
import time

T0 = time.time()          # set-up runs from here to the window's start

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, spec: dict) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or
    (a per-layer metric without the key) the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in spec["end_to_end"]
                     if m["name"] == metric["moves"])
        return reports(moved, cell, spec)
    return True


def reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


RUNNERS = {"kv_store": "store", "lm_decode": "decode"}


def runner(cfg: dict):
    """The runner module of a configuration's ``system``: ``bench/store.py``
    for ``kv_store``, ``bench/decode.py`` for ``lm_decode``.  Each gives a
    ``Run`` and the ``record`` its readers read."""
    system = cfg.get("system")
    if system not in RUNNERS:
        raise ValueError(f"unknown system {system!r} (known: "
                         f"{', '.join(sorted(RUNNERS))})")
    return importlib.import_module(f"bench.{RUNNERS[system]}")


def cell_files(spec: dict, name: str) -> tuple:
    """The cell ``name``, its configuration and its traffic mix."""
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def measure(spec: dict, name: str, seed: int, seconds: float, trace: bool,
            device: str, t0: float, log=err):
    """Run cell ``name`` once on ``device``: set-up, window, check, and the
    result line's keys (``checks`` last).  Returns ``(result, run)``."""
    import torch

    from bench import trace as trace_lib
    from repro_torch.kernels import _build

    cell, cfg, mix = cell_files(spec, name)
    mod = runner(cfg)
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = load_json(BENCH / "peaks.json").get(kind, {})
    run = mod.Run(cfg, mix, seed, seconds, trace, dev, log=log)
    run.setup()
    setup_s = time.time() - t0
    run.log_setup(name, setup_s, _build.build_seconds, kind)
    run.window()
    run.log_window()
    tr = None
    if run.segment is not None:
        tr = trace_lib.read(run.segment.pop("prof"))
    checks = run.check()
    rec = mod.record(run, tr, peaks)

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if reports(m, name, spec):
                v = reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = run.end_to_end()
        e2e["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if reports(m, name, spec) and m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    device_ = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": kind, "count": int(cell["chips"]),
               "memory_peak_bytes": int(run.memory_peak)}
    result = {"correct": run.correct, "attempted": int(run.attempted),
              "failed": int(run.failed),
              "metrics": metrics, "device": device_}
    if tr is not None:
        device_["busy_s"] = tr["busy_s"]
        device_["window_s"] = tr["window_s"]
        result["breakdown"] = trace_lib.breakdown(tr)
        for sec, label in trace_lib.longest_gaps(tr):
            log(f"[bench] idle gap {sec * 1e6:.1f} us: {label}")
    run.log_checked()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        err(f"[bench] no cell {args.workload!r} in BENCHMARK.json")
        return 2
    chips = int(cells[args.workload]["chips"])
    _, cfg, _ = cell_files(spec, args.workload)
    if cfg.get("system") not in RUNNERS:
        err(f"[bench] {args.workload}: unknown system "
            f"{cfg.get('system')!r} (known: {', '.join(sorted(RUNNERS))}): "
            f"no result")
        return 5

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        err(f"[bench] {args.workload} needs {chips} CUDA card(s); this "
            f"machine has {have}: no result")
        return 3
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    result, _ = measure(spec, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        err(f"[bench] loaded in this process: {', '.join(bad)}: no result")
        return 4
    for k, c in result["checks"].items():
        err(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
