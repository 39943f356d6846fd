"""On a card: one short run of every cell through the benchmark's own
command, each run correct and its result line complete.  Skipped without
a CUDA card (decided inside the test).  Run on the card with
``python3 -m pytest -q bench -m card``."""
import json
import subprocess
import sys

import pytest
import torch

from bench import run as bench_run

SPEC = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", name, "--seed",
         str(2**31 + 5 + trace), "--seconds", "5", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=bench_run.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] or trace
    if trace:
        assert res["device"]["busy_s"] > 0
