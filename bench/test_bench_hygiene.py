"""What the benchmark imports: never ``jax`` or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not (_top_level_imports(f) & FORBIDDEN), f


@pytest.mark.parametrize("name", ["lm_reference.py", "lm_inputs.py",
                                  "lm_counts.py"])
def test_the_decode_reference_imports_no_program(name):
    """The decode reference and what it makes its inputs and counts with
    import nothing of the program (``repro_torch``) either, directly or
    through another ``bench`` module."""
    seen, todo = set(), [name]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        path = BENCH / f
        tree = ast.parse(path.read_text())
        bad = _top_level_imports(path) & (FORBIDDEN | {"repro_torch"})
        assert not bad, (f, bad)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 1:
                if node.module:
                    todo.append(node.module.split(".")[0] + ".py")
                else:
                    todo += [a.name + ".py" for a in node.names]
    assert "lm_inputs.py" in seen or name != "lm_reference.py"


def test_a_run_loads_neither(tmp_path):
    """A tiny CPU run of every cell's internals, in a fresh process, leaves
    neither JAX nor the JAX package in ``sys.modules``."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH.parent / "src")!r}]
from bench import run as r
from repro_torch.models import api
from bench import lm_reference
from bench.test_bench_decode import SMALL_LIMITS
api.SPARSE_TOPK, api.SPARSE_LOCAL_FRAMES, api.FETCH_BUDGET = 4, 6, 2
lm_reference.LIMITS = SMALL_LIMITS
load = r.load_json
def small(path):
    d = load(path)
    if path.parent.name == "configs" and d["system"] == "lm_decode":
        d["model"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=512)
        d["plane"].update(topk_pages=4, local_frames=6, fetch_budget=2)
    elif path.parent.name == "configs":
        d.update(objects=32768, fill_batch=4096, warm_ticks=2)
    if path.parent.name == "traffic":
        d["rate_per_s"] = min(d.get("rate_per_s", 0), 5000)
        d["max_requests_per_s"] = 50000
        d.update(capacity_tokens=4096, context_tokens=1920, warm_steps=4)
    return d
r.load_json = small
spec = load(r.ROOT / "BENCHMARK.json")
for w in spec["workloads"]:
    res, _ = r.measure(spec, w["name"], 5, 0.3, False, "cpu", time.time(),
                       log=lambda *a: None)
    assert res["correct"], res
print(json.dumps(r.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
