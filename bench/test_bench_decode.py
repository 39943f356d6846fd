"""The decode cell on the CPU at its kit's smoke size (``lm_dense.SMOKE``:
2 layers, d 64, 4 heads, 2 KV heads, 1,920 tokens of context in 64-token
pages, top 4 of them, 6 frames, 2 fetched a step): the reference against
``models.api.decode_step``, the runner end to end, the faults its check
must refuse, the control, and the dispatch by ``system`` and ``kit``."""
import json
import time

import pytest
import torch

from bench import decode, lm_counts, lm_dense, lm_inputs, lm_reference
from bench import run as bench_run
from bench.lm_faults import FAULTS

SPEC = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
CELL = "yi-9b-200k.long"
SEED = 2**31 + 41
SMALL_LIMITS = lm_dense.SMOKE["limits"]


@pytest.fixture
def small(monkeypatch):
    """The cell's files at its kit's smoke size, and the program's plane
    constants and the kit's limits to match."""
    files = bench_run.cell_files

    def scaled(spec, name):
        cell, cfg, mix = files(spec, name)
        return (cell, *decode.at_smoke_size(cfg, mix)[:2])
    for obj, attr, value in decode.at_smoke_size(*files(SPEC, CELL)[1:])[2]:
        monkeypatch.setattr(obj, attr, value)
    monkeypatch.setattr(bench_run, "cell_files", scaled)


def _measure(trace=False, seconds=0.6):
    return bench_run.measure(SPEC, CELL, SEED, seconds, trace, "cpu",
                             time.time(), log=lambda *a: None)


def _files():
    _, cfg, mix = bench_run.cell_files(SPEC, CELL)
    return cfg, mix


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_decode_step(small, dtype):
    """Steps from the seeded context through ``api.decode_step``, across a
    page boundary and with fetches every step: the reference, given the
    program's selections and residency, agrees with the program's logits
    to rounding; its own selections score no page left out above one
    chosen; the rows attended are the reference's row for row."""
    cfg, mix = _files()
    cfg["model"]["dtype"] = dtype
    mix = dict(mix, warm_steps=70)          # 1920 -> 1990: past page 30
    run = decode.Run(cfg, mix, SEED, 0.0, False, "cpu")
    run.setup()
    assert run.pos == 1990
    run.window()
    checks = run.check()
    r = run.readings
    assert r["layer0_rows"] == 1990 - 1920 + decode.CHECKED
    # bf16: the program rounds every product's output and the logits
    # themselves (2**-9 of an entry; the widest of 512 entries is some
    # three RMS), through two layers at d 64
    tol = 1e-5 if dtype == "float32" else 0.06
    assert checks["logits_max_gap"][0] < tol, r
    assert checks["append_max_gap"][0] < tol, r
    assert checks["selection_mismatch"][0] == 0
    assert checks["rows_mismatch"][0] == 0
    assert checks["pageout_mismatch"][0] == 0
    if dtype == "float32":
        assert checks["selection_gap"][0] < 1e-6
        assert checks["marks_max_gap"][0] < 1e-3
    assert sum(r["fetched_pages"]) > 0
    assert run.correct, checks


def test_runner_end_to_end(small):
    result, run = _measure()
    assert result["correct"], result["checks"]
    assert result["attempted"] == run.steps > decode.CHECKED
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"decode_tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(lm_reference.LIMITS)
    json.dumps(result)


def test_runner_traced(small):
    result, run = _measure(trace=True, seconds=1.0)
    assert result["correct"], result["checks"]
    assert run.segment is not None and run.segment["steps"] > 0
    got = result["metrics"]
    # the CPU has no device trace: the host readings and the counts only
    assert got["decode.host_ms_per_step.long"]["value"] > 0
    assert "kvplane.device_us_per_step.long" not in got
    assert "window_s" in result["device"] and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(small, monkeypatch, fault):
    mod, name, wrap = FAULTS[fault]
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    result, _ = _measure()
    assert not result["correct"], result["checks"]


def test_control_is_refused(small):
    """The reference in float8 in the program's place, at the smoke size:
    on three seeds it fails a limit that sound runs pass."""
    from bench import lm_control
    for seed in (1, 2, 3):
        r = lm_control.readings(SPEC, CELL, seed, 0.3, "cpu", control=True)
        assert any(r["control"][k] > lim
                   for k, lim in SMALL_LIMITS.items()), r
        assert all(r["program"][k] <= lim
                   for k, lim in SMALL_LIMITS.items()), r


def test_unknown_system_is_refused(monkeypatch, capsys):
    load = bench_run.load_json

    def other(path):
        d = load(path)
        if path.parent.name == "configs":
            d["system"] = "no_such_system"
        return d
    monkeypatch.setattr(bench_run, "load_json", other)
    rc = bench_run.main(["--workload", "mcd-cl.closed", "--seed", "1",
                         "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "unknown system" in out.err
    with pytest.raises(ValueError, match="unknown system"):
        bench_run.runner({"system": "no_such_system"})


def test_unknown_kit_is_refused(monkeypatch):
    """A configuration that names a kit with no file under ``bench/`` is
    refused before anything is made, with the kit's name."""
    files = bench_run.cell_files

    def other(spec, name):
        cell, cfg, mix = files(spec, name)
        return cell, dict(cfg, kit="no_such_kit"), mix
    monkeypatch.setattr(bench_run, "cell_files", other)
    with pytest.raises(ValueError, match="no_such_kit.*no bench/no_such_kit"):
        bench_run.measure(SPEC, CELL, SEED, 0.1, False, "cpu", time.time(),
                          log=lambda *a: None)
    for bad in ("../run", "lm dense", 3):
        with pytest.raises(ValueError, match="names the kit"):
            decode.kit_of({"name": "x", "kit": bad})
    assert decode.kit_of({"name": "x"}) is lm_dense


def test_store_cell_keeps_its_keys():
    """The store's cell goes to ``bench/store.py`` and reads its own
    checks."""
    from bench import store
    _, cfg, _ = bench_run.cell_files(SPEC, "mcd-cl.closed")
    assert bench_run.runner(cfg) is store
    assert set(store.reference.LIMITS) == {"rows_wrong", "max_abs_gap",
                                           "readback_wrong", "missing"}


def test_counts_of_the_cell():
    """The step's operations and bytes at the cell's own sizes: weights
    once (17.1 GB of the 17.6 GB the model holds: the embedding's one
    row), 48 layers of summaries over 3,125 pages, the rows attended."""
    cfg, mix = bench_run.load_json(
        bench_run.BENCH / "configs" / "yi-9b-200k.json"), None
    c = lm_counts.StepCounts(attended_rows=48 * 64 * 64, fetched_pages=48 * 4,
                             summary_pages=3125, page_tokens=64)
    flops = lm_counts.step_flops(cfg["model"], c)
    assert 20.0e9 < flops < 20.6e9
    b = lm_counts.step_bytes(cfg["model"], c)
    m = lm_inputs.dims(cfg["model"])
    weights = 2 * (m["L"] * sum(a * b_ for a, b_ in
                                lm_inputs.layer_shapes(m).values())
                   + m["d"] * m["vp"])
    assert 17.0e9 < weights < 17.2e9
    assert 18.0e9 < b < 18.4e9


def _decode_rec(device_ops=(), busy_s=0.2):
    tr = {"window_s": 1.0, "busy_s": busy_s, "device_ops": list(device_ops),
          "gaps": [], "spans": [], "ops": []}
    return {"host_s": [0.1, 0.1, 0.2, 0.2],
            "segment": {"steps": 4, "trace": tr, "before": (3.0, 30)},
            "flops_per_step": 2.0e10, "bytes_per_step": 1.8e10,
            "flops_per_s": 989.4e12, "hbm_bytes_per_s": 3.35e12}


def test_decode_readers():
    ops_ = [("void page_scores_kernel<float>(x)", 0.0, 30.0),
            ("void repro::row_copy<repro::tag::gather_rows, uint4, false, "
             "true>(x)", 50.0, 10.0),
            ("ampere_bf16_gemm(x)", 70.0, 500.0)]
    rec = _decode_rec(ops_)
    r = {m["name"]: bench_run.reader(m["name"])(rec) for m in SPEC["per_layer"]
         if m.get("workloads") == [CELL]}
    assert r["decode.host_ms_per_step.long"] == pytest.approx(150.0)
    # 0.1 s a step before the segment
    assert r["decode.step_mfu.long"] == pytest.approx(
        100 * 2.0e10 / 0.1 / 989.4e12)
    assert r["decode.hbm_roofline.long"] == pytest.approx(
        100 * 1.8e10 / 3.35e12 / 0.1)
    assert r["kvplane.device_us_per_step.long"] == pytest.approx(10.0)
    # busy 50 ms a step against 100 ms of wall a step
    assert r["device.idle_share.long"] == pytest.approx(50.0)


def test_decode_readers_find_nothing_to_read():
    rec = _decode_rec()
    for name in ("kvplane.device_us_per_step.long",
                 "device.idle_share.long"):
        assert bench_run.reader(name)(rec) is None
    rec["segment"] = None
    rec["host_s"] = []
    for m in SPEC["per_layer"]:
        if m.get("workloads") == [CELL]:
            assert bench_run.reader(m["name"])(rec) is None, m["name"]
