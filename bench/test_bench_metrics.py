"""The trace reduction and the per-layer readers on synthetic input."""
import numpy as np

from bench import run as bench_run
from bench import trace


def test_innermost_of_nested_spans():
    events = [("a", 0.0, 10.0), ("b", 1.0, 3.0), ("c", 2.0, 1.0),
              ("d", 6.0, 2.0)]
    got = trace._innermost(events, [0.5, 1.5, 2.5, 3.5, 4.5, 7.0, 11.0])
    assert got == ["a", "b", "c", "b", "a", "d", None]


def test_short_name_drops_arguments():
    n = ("void repro::row_copy<repro::tag::gather_rows, uint4, true, "
         "true>(uint4 const*, long, int const*, long)")
    assert trace.short_name(n) == ("repro::row_copy<repro::tag::gather_rows,"
                                   " uint4, true, true>")


def _rec(device_ops, window_s=1.0, busy_s=0.25):
    tr = {"window_s": window_s, "busy_s": busy_s, "device_ops": device_ops,
          "gaps": [], "spans": [], "ops": []}
    seg = {"ticks": 10, "keys": 10 * 1024, "trace": tr, "before": (2.0, 100),
           "stats": {"obj_ins": 500, "page_ins": 20, "evac_moved": 8}}
    return {"ticks": [(0.01, False)] * 99 + [(0.05, True)],
            "queue_s": np.array([0.001] * 99 + [0.2]),
            "window_stats": {"hits": 300, "misses": 100, "obj_ins": 75,
                             "page_ins": 25},
            "segment": seg, "row_bytes": 128, "page_bytes": 1024,
            "hbm_bytes_per_s": 3.35e12}


def test_readers():
    ops = [("void repro::row_copy<a>(x)", 0.0, 40.0),
           ("void cat_decay_kernel<true>(x)", 50.0, 10.0),
           ("at::native::fill(x)", 70.0, 5.0)]
    rec = _rec(ops)
    r = {name: bench_run.reader(name)(rec) for name in (
        "engine.host_ms_per_tick.closed", "plane.miss_ratio.closed",
        "plane.object_share.closed", "kernels.device_us_per_tick.closed",
        "rowcopy_roofline.closed", "device.idle_share.closed",
        "device.ops_per_tick.closed", "evac.tick_ms.closed",
        "evac.tick_ms.open", "engine.queue_ms.open")}
    assert abs(r["engine.host_ms_per_tick.closed"] - 10.4) < 1e-9
    assert r["plane.miss_ratio.closed"] == 25.0
    assert r["plane.object_share.closed"] == 75.0
    assert r["kernels.device_us_per_tick.closed"] == 5.0
    need = 2 * ((10 * 1024 + 500 + 8) * 128 + 20 * 1024)
    assert abs(r["rowcopy_roofline.closed"]
               - 100 * need / 3.35e12 / 40e-6) < 1e-9
    # busy 25 ms a tick against 20 ms of wall a tick outside the segment
    assert abs(r["device.idle_share.closed"] - 100 * (1 - 0.025 / 0.02)) < 1e-9
    assert r["device.ops_per_tick.closed"] == 0.3
    assert abs(r["evac.tick_ms.closed"] - 50.0) < 1e-9
    assert abs(r["evac.tick_ms.open"] - 50.0) < 1e-9
    assert r["engine.queue_ms.open"] > 1.0


def test_readers_find_nothing_to_read():
    rec = _rec([])
    rec["segment"]["trace"] = None
    for name in ("kernels.device_us_per_tick.closed",
                 "rowcopy_roofline.closed", "device.idle_share.closed",
                 "device.ops_per_tick.closed"):
        assert bench_run.reader(name)(rec) is None
    rec["window_stats"] = {"hits": 0, "misses": 0, "obj_ins": 0,
                           "page_ins": 0}
    assert bench_run.reader("plane.miss_ratio.closed")(rec) is None
    assert bench_run.reader("plane.object_share.closed")(rec) is None


def test_every_metric_has_a_reader_and_every_cell_reports():
    spec = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    for m in spec["per_layer"]:
        assert callable(bench_run.reader(m["name"]))
    for w in spec["workloads"]:
        e2e = [m["name"] for m in spec["end_to_end"]
               if bench_run.reports(m, w["name"], spec)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(bench_run.reports(m, w["name"], spec)
                   for m in spec["per_layer"])
