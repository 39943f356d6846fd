"""What the benchmark imports: never ``jax`` or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port)."""
import ast
import subprocess
import sys
from pathlib import Path

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


def test_a_run_loads_neither(tmp_path):
    """A tiny CPU run of every cell's internals, in a fresh process, leaves
    neither JAX nor the JAX package in ``sys.modules``."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH.parent / "src")!r}]
from bench import run as r
load = r.load_json
def small(path):
    d = load(path)
    if path.parent.name == "configs":
        d.update(objects=32768, fill_batch=4096, warm_ticks=2)
    if path.parent.name == "traffic":
        d["rate_per_s"] = min(d.get("rate_per_s", 0), 5000)
        d["max_requests_per_s"] = 50000
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
