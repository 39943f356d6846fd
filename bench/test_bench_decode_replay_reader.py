"""The reader of the decode step's graph replays
(``decode.replay_share.long``) on synthetic traces."""
import pytest

from bench import run as bench_run

NAME = "decode.replay_share.long"
SPEC = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")


def _rec(span_list, steps=4):
    tr = {"window_s": 1.0, "busy_s": 0.0, "device_ops": [], "gaps": [],
          "spans": list(span_list), "ops": []}
    return {"segment": {"steps": steps, "trace": tr, "before": (30.0, 600)},
            "host_s": [0.05]}


def _steps(n, replayed):
    """``n`` steps of 50,000 us, each in its ``bench.step`` span, the first
    ``replayed`` launched from the graph."""
    out = [("bench.window", 0.0, n * 50_000.0)]
    for t in range(n):
        out.append(("bench.step", t * 50_000.0, 49_000.0))
        if t < replayed:
            out.append(("engine.decode.replay", t * 50_000.0 + 40.0, 20.0))
    return out


def test_the_metric_is_in_the_benchmark():
    m = next(m for m in SPEC["per_layer"] if m["name"] == NAME)
    assert m["unit"] == "%" and m["better"] == "higher"
    assert m["source"] == "device_trace"
    assert m["moves"] == "decode_tokens_per_s"
    assert m["layer"] == "model decode (models/api.py)"
    assert m["workloads"] == ["yi-9b-200k.long"]


@pytest.mark.parametrize("replayed, want", [(4, 100.0), (3, 75.0),
                                            (1, 25.0)])
def test_replayed_steps_over_the_segment(replayed, want):
    read = bench_run.reader(NAME)
    assert read(_rec(_steps(4, replayed))) == pytest.approx(want)


def test_nothing_to_read():
    """The trace of a step that runs eagerly (on the CPU, say), or no
    segment: None."""
    read = bench_run.reader(NAME)
    assert read(_rec(_steps(4, 0))) is None
    assert read({"segment": None}) is None
    rec = _rec([])
    rec["segment"]["trace"] = None
    assert read(rec) is None
    rec = _rec(_steps(4, 4), steps=0)
    assert read(rec) is None
