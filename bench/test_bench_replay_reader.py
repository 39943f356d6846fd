"""The reader of the engine's graph replays
(``engine.replay_share.closed``) on synthetic traces."""
import pytest

from bench import run as bench_run

NAME = "engine.replay_share.closed"
SPEC = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")


def _rec(span_list, ticks=64):
    tr = {"window_s": 1.0, "busy_s": 0.0, "device_ops": [], "gaps": [],
          "spans": list(span_list), "ops": []}
    return {"segment": {"ticks": ticks, "trace": tr, "stats": {}, "keys": 0,
                        "before": (1.0, 10)}}


def _ticks(n, replayed):
    """``n`` ticks of 1,000 us, an execute in each, replayed in the first
    ``replayed``; an evacuation round's replay in the first."""
    out = [("engine.evacuate.replay", 500.0, 100.0)]
    for t in range(n):
        out.append(("engine.execute", t * 1000.0, 50.0))
        if t < replayed:
            out.append(("engine.execute.replay", t * 1000.0 + 5.0, 30.0))
    return out


def test_the_metric_is_in_the_benchmark():
    m = next(m for m in SPEC["per_layer"] if m["name"] == NAME)
    assert m["unit"] == "%" and m["better"] == "higher"
    assert m["moves"] == "requests_per_s"
    assert m["layer"] == "engine (serving/engine.py)"
    assert m["workloads"] == ["mcd-cl.closed"]


@pytest.mark.parametrize("replayed, want", [(64, 100.0), (48, 75.0)])
def test_replayed_ticks_over_the_segment(replayed, want):
    read = bench_run.reader(NAME)
    assert read(_rec(_ticks(64, replayed))) == pytest.approx(want)


def test_nothing_to_read():
    """An eager engine's trace (the parent's), or no segment: None."""
    read = bench_run.reader(NAME)
    assert read(_rec(_ticks(64, 0))) is None
    assert read({"segment": None}) is None
    rec = _rec([])
    rec["segment"]["trace"] = None
    assert read(rec) is None
