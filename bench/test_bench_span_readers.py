"""The readers of the program's spans (``bench/spans.py`` and its two
metrics) on synthetic traces, and on a traced CPU run of each cell."""
import time

import pytest

from bench import run as bench_run
from bench import spans

SPEC = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
SPAN_METRICS = ("engine.wait_ms_per_tick.closed",
                "evac.device_ms_per_round.closed")
HOST_SPAN_METRICS = SPAN_METRICS[:-1]
SEED = 2**31 + 77


def _rec(span_list, device_ops=(), ticks=4, gaps=()):
    tr = {"window_s": 1.0, "busy_s": 0.0, "device_ops": list(device_ops),
          "gaps": list(gaps), "spans": list(span_list), "ops": []}
    return {"segment": {"ticks": ticks, "trace": tr, "stats": {}, "keys": 0,
                        "before": (1.0, 10)}}


def _read(name, rec):
    return bench_run.reader(name)(rec)


def test_every_span_metric_is_in_the_benchmark():
    names = {m["name"]: m for m in SPEC["per_layer"]}
    for n in SPAN_METRICS:
        m = names[n]
        assert m["moves"] == "requests_per_s" and m["unit"] == "ms"
        assert m["workloads"] == ["mcd-cl.closed"]
    # the readers of spans that run only while a tick is captured are gone
    for n in ("plan.host_ms_per_tick.closed",
              "execute.object_path_ms_per_tick.closed",
              "execute.paging_path_ms_per_tick.closed",
              "evac.plan_ms_per_round.closed"):
        assert n not in names
        assert not (bench_run.BENCH / "metrics" / f"{n}.py").exists()


def test_nested_duplicates_count_once():
    """An ``engine.wait`` nested in one of its own name (a wrapper around
    the program's span): one interval."""
    rec = _rec([("engine.wait", 100.0, 1000.0),      # the wrapper's
                ("engine.wait", 110.0, 980.0),       # the program's
                ("engine.wait", 3000.0, 600.0),
                ("engine.wait", 3000.0, 600.0),
                ("engine.plan", 5000.0, 40.0)])
    assert spans.total_us(rec["segment"]["trace"], "engine.wait") == 1600.0
    assert _read("engine.wait_ms_per_tick.closed", rec) == pytest.approx(0.4)


def test_overlapping_intervals_join():
    tr = _rec([("a", 0.0, 10.0), ("a", 5.0, 10.0), ("a", 20.0, 1.0)])
    tr = tr["segment"]["trace"]
    assert spans.intervals(tr, "a") == [[0.0, 15.0], [20.0, 21.0]]
    assert spans.total_us(tr, "a") == 16.0
    assert spans.total_us(tr, "b") is None


def test_phase_readers_read_their_span():
    """The wait reader reads its own span alone, over the segment's ticks,
    whatever other phases the trace holds."""
    rec = _rec([("engine.execute", 0.0, 900.0),
                ("engine.execute.runtime", 100.0, 400.0),
                ("engine.retire", 1000.0, 700.0),
                ("engine.wait", 1010.0, 300.0),
                ("engine.evacuate", 2000.0, 8000.0),
                ("engine.retire", 20000.0, 900.0),
                ("engine.wait", 20010.0, 500.0)])
    assert _read("engine.wait_ms_per_tick.closed", rec) == pytest.approx(0.2)


def test_evacuation_device_time_counts_from_the_first_idle_moment():
    """A round counts the operations that start inside it once the device
    has stood idle in it: all of them where its opening is idle, those
    after the busy run its opening found otherwise; an operation running
    at its close counts whole, one starting after it not at all."""
    rounds = [("engine.evacuate", 1000.0, 1000.0),    # idle ends
              ("engine.evacuate", 5000.0, 1000.0)]    # busy at its start
    ops = [("before", 900.0, 50.0),                   # ends before round 1
           ("k1", 1100.0, 30.0), ("k2", 1500.0, 70.0),
           ("long", 4900.0, 200.0),                   # spans round 2's start
           ("queued", 5100.0, 50.0),                  # same busy run
           ("k3", 5300.0, 10.0)]
    # the reduction's idle gaps of a window from 0 to 8,000 us
    gaps = [(0.0, 900.0), (950.0, 1100.0), (1130.0, 1500.0),
            (1570.0, 4900.0), (5150.0, 5300.0), (5310.0, 8000.0)]
    rec = _rec(rounds, ops, gaps=gaps)
    # (100 + 10) us over two rounds
    assert _read("evac.device_ms_per_round.closed",
                 rec) == pytest.approx(0.055)
    busy_start = _rec(rounds[1:], ops, gaps=gaps)
    assert _read("evac.device_ms_per_round.closed",
                 busy_start) == pytest.approx(0.01)
    busy_end = _rec([("engine.evacuate", 1000.0, 520.0)], ops,  # ends in k2
                    gaps=gaps)
    assert _read("evac.device_ms_per_round.closed",
                 busy_end) == pytest.approx(0.1)
    before_k2 = _rec([("engine.evacuate", 1000.0, 480.0)], ops, gaps=gaps)
    assert _read("evac.device_ms_per_round.closed",
                 before_k2) == pytest.approx(0.03)
    never_idle = _rec([("engine.evacuate", 4950.0, 150.0)], ops, gaps=gaps)
    assert _read("evac.device_ms_per_round.closed", never_idle) is None
    past_the_last_gap = _rec([("engine.evacuate", 8100.0, 100.0)], ops,
                             gaps=gaps)
    assert _read("evac.device_ms_per_round.closed",
                 past_the_last_gap) is None


def test_readers_find_nothing_to_read():
    """A trace without the program's spans (the parent's) or without a
    segment reads None and raises nothing."""
    bare = _rec([("engine.submit", 0.0, 10.0)])
    empty = {"segment": None}
    for name in SPAN_METRICS:
        assert _read(name, bare) is None, name
        assert _read(name, empty) is None, name
    no_device = _rec([("engine.evacuate", 0.0, 10.0)], gaps=[(0.0, 20.0)])
    assert _read("evac.device_ms_per_round.closed", no_device) is None


@pytest.fixture
def small(monkeypatch):
    """The cells' files at 32,768 objects and an evacuation round every 8
    ticks, as ``test_bench_cells.py`` scales them."""
    load = bench_run.load_json

    def scaled(path):
        d = load(path)
        if path.parent.name == "configs":
            d.update(objects=32768, fill_batch=4096, warm_ticks=8)
            d["engine"] = dict(d["engine"], evac_every=8)
        elif path.parent.name == "traffic":
            d["rate_per_s"] = min(d.get("rate_per_s", 0), 20_000)
            d["max_requests_per_s"] = 200_000
        return d
    monkeypatch.setattr(bench_run, "load_json", scaled)


def test_traced_cpu_run_reads_the_host_spans(small):
    """A traced run of ``mcd-cl.closed`` on the CPU: the host-span
    reading, positive; the device reading needs a card's trace."""
    result, run = bench_run.measure(SPEC, "mcd-cl.closed", SEED, 2.5, True,
                                    "cpu", time.time(), log=lambda *a: None)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    for name in HOST_SPAN_METRICS:
        assert got[name]["value"] > 0, name
    assert "evac.device_ms_per_round.closed" not in got
    assert run.segment["ticks"] > 0
