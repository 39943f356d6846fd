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


def _yardsticks() -> list:
    """The benchmark's references and counts: every module under
    ``bench/`` (tests aside) whose name says it is one."""
    return sorted(p.name for p in BENCH.glob("*.py")
                  if ("reference" in p.stem or "counts" in p.stem)
                  and not p.stem.startswith("test_"))


@pytest.mark.parametrize("name", _yardsticks())
def test_the_decode_reference_imports_no_program(name):
    """A reference, and what it makes its inputs and counts with, import
    nothing of the program (``repro_torch``) either, directly or through
    another ``bench`` module."""
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
            elif isinstance(node, ast.ImportFrom) and node.module == "bench":
                todo += [a.name + ".py" for a in node.names]
            elif isinstance(node, ast.ImportFrom) and \
                    node.module.startswith("bench."):
                todo.append(node.module.split(".")[1] + ".py")
    assert "lm_inputs.py" in seen or name != "lm_reference.py"


def test_every_reference_is_checked():
    """The references of both runners are among what the test above
    reads, found by name alone."""
    assert {"reference.py", "lm_reference.py",
            "lm_counts.py"} <= set(_yardsticks())


def test_a_run_loads_neither(tmp_path):
    """A tiny CPU run of every cell's internals, in a fresh process, leaves
    neither JAX nor the JAX package in ``sys.modules``: each decode cell at
    its kit's smoke size (``bench.decode.at_smoke_size``), each store cell
    at 32,768 objects."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH.parent / "src")!r}]
from bench import run as r
from bench import decode
spec = r.load_json(r.ROOT / "BENCHMARK.json")
files = r.cell_files
for w in spec["workloads"]:
    cell, cfg, mix = files(spec, w["name"])
    patches = []
    if cfg["system"] == "lm_decode":
        cfg, mix, patches = decode.at_smoke_size(cfg, mix)
    else:
        cfg.update(objects=32768, fill_batch=4096, warm_ticks=2)
        mix["rate_per_s"] = min(mix.get("rate_per_s", 0), 5000)
        mix["max_requests_per_s"] = 50000
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, v in patches:
        setattr(o, a, v)
    r.cell_files = lambda s, n, got=(cell, cfg, mix): got
    res, _ = r.measure(spec, w["name"], 5, 0.3, False, "cpu", time.time(),
                       log=lambda *a: None)
    for o, a, v in saved:
        setattr(o, a, v)
    assert res["correct"], res
print(json.dumps(r.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
