"""Each store cell's run on the CPU at 32,768 objects with the port's
plain kernels: set-up, window, check and metrics as the card runs them
(the harness's look for a card skipped); then the same runs with the timed
path broken underneath, which the check must refuse.  The decode cells'
are in ``test_bench_decode.py``."""
import json
import time

import pytest
import torch

from bench import run as bench_run
from repro_torch.core import batch as batch_lib
from repro_torch.kernels import ops

SPEC = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]
         if bench_run.cell_files(SPEC, w["name"])[1]["system"] == "kv_store"]
SEED = 2**31 + 99


@pytest.fixture
def small(monkeypatch):
    """The cells' files at 32,768 objects and a short warm-up."""
    load = bench_run.load_json

    def scaled(path):
        d = load(path)
        if path.parent.name == "configs":
            d.update(objects=32768, fill_batch=4096, warm_ticks=8)
            # an evacuation round every 8 ticks, so that a short CPU
            # window holds some before its traced segment
            d["engine"] = dict(d["engine"], evac_every=8)
        elif path.parent.name == "traffic":
            d["rate_per_s"] = min(d.get("rate_per_s", 0), 20_000)
            d["max_requests_per_s"] = 200_000
        return d
    monkeypatch.setattr(bench_run, "load_json", scaled)


def _measure(name, trace=False, seconds=1.0):
    return bench_run.measure(SPEC, name, SEED, seconds, trace, "cpu",
                             time.time(), log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(small, name):
    result, run = _measure(name)
    assert result["correct"], result["checks"]
    assert run.occupancy_at_start == 1.0
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in SPEC["end_to_end"]
            if bench_run.reports(m, name, SPEC)}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    s = run.window_stats
    assert s["page_ins"] > 0 and s["obj_ins"] > 0 and s["page_outs"] > 0
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced(small, name):
    result, run = _measure(name, trace=True, seconds=2.5)
    assert result["correct"]
    assert run.segment is not None and run.segment["ticks"] > 0
    host = {"engine.host_ms_per_tick.closed", "plane.miss_ratio.closed",
            "plane.object_share.closed"}
    if any(evac for _, evac in run.ticks):
        host.add("evac.tick_ms.closed")
    want = {m["name"] for m in SPEC["per_layer"]
            if bench_run.reports(m, name, SPEC)} & host
    assert want <= set(result["metrics"])
    assert "window_s" in result["device"] and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_open_loop_runs_and_is_correct(small):
    """The open loop (``bench/traffic/open.json``), which no cell runs
    while its tail is unsteady: Poisson arrivals, every request served,
    judged and given a latency."""
    from bench import store
    load = bench_run.load_json
    cfg = load(bench_run.BENCH / "configs" / "mcd-cl.json")
    mix = load(bench_run.BENCH / "traffic" / "open.json")
    run = store.Run(cfg, mix, SEED, 1.0, False, "cpu", log=lambda *a: None)
    run.setup()
    run.window()
    run.check()
    assert run.correct, run.checks
    assert run.attempted == run.arrivals.size > 0
    assert run.checks["missing"][0] == 0
    assert run.end_to_end()["p99_ms"] > 0
    rec = store.record(run, None, {})
    assert bench_run.reader("engine.queue_ms.open")(rec) >= 0


def _stale(orig):
    """A step that returns the rows of the call before it."""
    last = {}

    def execute(cfg, s, obj_ids, plan, **kw):
        s, rows = orig(cfg, s, obj_ids, plan, **kw)
        prev = last.get("rows", rows)
        last["rows"] = rows
        return s, prev
    return execute


def _half(orig):
    """Half of every batch left out (zero rows)."""
    def execute(cfg, s, obj_ids, plan, **kw):
        s, rows = orig(cfg, s, obj_ids, plan, **kw)
        rows = rows.clone()
        rows[rows.shape[0] // 2:] = 0
        return s, rows
    return execute


def _altered(orig):
    """One element of one answer altered where it is produced."""
    def execute(cfg, s, obj_ids, plan, **kw):
        s, rows = orig(cfg, s, obj_ids, plan, **kw)
        rows = rows.clone()
        rows[3, 5] += 1.0
        return s, rows
    return execute


def _rows_into(width):
    """``gather_rows_into`` copying the wrong source rows where its rows
    are ``width`` wide: object fetches (a row) or page-ins (a page)."""
    orig = ops.gather_rows_into

    def into(dst, dst_idx, pool, idx, **kw):
        if dst.shape[1] == width:
            idx = torch.where(idx >= 0, (idx + 1) % pool.shape[0], idx)
        return orig(dst, dst_idx, pool, idx, **kw)
    return into


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered",
                                   "object_fetch", "page_in"])
def test_broken_path_is_not_correct(small, monkeypatch, name, fault):
    if fault in ("stale", "half", "altered"):
        wrap = {"stale": _stale, "half": _half, "altered": _altered}[fault]
        monkeypatch.setattr(batch_lib, "execute_access",
                            wrap(batch_lib.execute_access))
    else:
        cell = next(w for w in SPEC["workloads"] if w["name"] == name)
        cfg = bench_run.load_json(bench_run.BENCH / "configs"
                                  / f"{cell['config']}.json")
        width = cfg["obj_dim"] * (1 if fault == "object_fetch"
                                  else cfg["page_objs"])
        monkeypatch.setattr(ops, "gather_rows_into", _rows_into(width))
    result, _ = _measure(name)
    assert not result["correct"], result["checks"]
