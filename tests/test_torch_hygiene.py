"""Hygiene of the port: it stands alone beside the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import expertplane, kvplane, state
from repro_torch.core.layout import PlaneConfig
from repro_torch.checkpoint import ckpt
from repro_torch.launch import dryrun, serve, train
from repro_torch.models import api
from repro_torch.serving.engine import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path} imports {bad}"


# A JAX module whose port has another name: XLA's HLO has no PyTorch
# meaning, so the port counts DTensor's collectives instead.
RENAMED = {"analysis/hlo.py": "analysis/comm.py"}
# JAX's public functions whose counterparts are the port's own entry
# points, by module.  The jit wrappers (``jitted_*``) memoize a compiled,
# state-donating program of a plane function; the port's plane functions
# update their state in place and run eagerly, so the function itself is
# the entry point (``kvplane.jitted_sharded_decode`` stays: it picks the
# loop or the process-group path).  JAX's far mesh is a process group
# here (``make_far_group``, with ``put_far`` laying the shards out).  HLO's
# computations and their loop trip counts have no PyTorch meaning: the port
# unrolls the layers and ``comm.TraceCounter`` records each collective as
# it is issued.
PORT_ENTRY_POINTS = {
    "analysis/hlo.py": {"parse_computations", "computation_multipliers"},
    "core/baselines.py": {"jitted_execute_object", "jitted_execute_paging",
                          "jitted_object_access", "jitted_paging_access",
                          "jitted_plan_object", "jitted_plan_paging"},
    "core/expertplane.py": {"jitted_ensure_resident", "jitted_moe_decode"},
    "core/kvplane.py": {"jitted_attend_sparse"},
    "core/plane.py": {"jitted_access", "jitted_advance_epoch",
                      "jitted_evacuate", "jitted_execute_access",
                      "jitted_execute_evacuate", "jitted_plan_access",
                      "jitted_plan_evacuate", "jitted_update"},
    "core/shardplane.py": {"jitted_phase_probe"},
    "launch/mesh.py": {"far_specs", "make_far_mesh"},
}


def _top_level(path: Path, functions_only: bool) -> set:
    """The names a module defines at its top level: its functions, or
    every name it binds (functions, classes, assignments, imports)."""
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.FunctionDef):
            out.add(node.name)
        elif functions_only:
            continue
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
    return out


def test_port_package_is_complete():
    """Every module of the JAX package has its counterpart in the port,
    and every public function at the top level of a JAX module is at the
    top level of its counterpart, but for PORT_ENTRY_POINTS; the CUDA
    sources of the six kernels are there."""
    port, jaxpkg = ROOT / "src" / "repro_torch", ROOT / "src" / "repro"
    mods = sorted(str(p.relative_to(jaxpkg)) for p in jaxpkg.rglob("*.py"))
    assert len(mods) > 40 and "core/paths.py" in mods
    missing = {}
    for mod in mods:
        ported = port / RENAMED.get(mod, mod)
        assert ported.exists(), mod
        public = {n for n in _top_level(jaxpkg / mod, True)
                  if not n.startswith("_")}
        gap = public - _top_level(ported, False) - PORT_ENTRY_POINTS.get(
            mod, set())
        if gap:
            missing[mod] = sorted(gap)
    assert not missing, missing
    for mod, names in PORT_ENTRY_POINTS.items():   # the list stays true
        assert names <= _top_level(jaxpkg / mod, True), mod
    for src in ("gather_rows.cu", "compact_pages.cu", "cat_decay.cu",
                "page_scores.cu", "paged_attention.cu", "cat_update.cu",
                "row_gather.cuh"):
        assert (port / "kernels" / "csrc" / src).exists(), src


CFG = PlaneConfig(num_objs=64, obj_dim=4, page_objs=8, num_frames=4,
                  num_vpages=16)


def test_entry_points_default_to_cuda(tmp_path):
    """Without a ``device`` the entry points take the card; on a machine
    without one they raise instead of falling back to the CPU."""
    data = np.zeros((64, 4), np.float32)
    kv_cfg = kvplane.KVPlaneConfig(kv_heads=1, head_dim=8, page_tokens=4,
                                   num_pages=2, num_frames=2, batch=1)
    ep_cfg = expertplane.ExpertPlaneConfig(n_experts=4, d_model=8, d_ff=8,
                                           hot_slots=2, topk=1,
                                           fetch_budget=1)
    lm = configs.get_smoke("llama3-8b")
    shape = configs.ShapeConfig("t", 64, 1, "decode")
    calls = [lambda: state.create(CFG, torch.from_numpy(data)),
             lambda: kvplane.init(kv_cfg),
             lambda: Engine(EngineConfig(batch=8), CFG, data),
             lambda: serve.main(["--objects", "64", "--steps", "1"]),
             lambda: expertplane.init(ep_cfg),
             lambda: api.init_decode_state(lm, shape),
             lambda: serve.main(["--mode", "lm", "--tokens", "1",
                                 "--batch", "1"]),
             lambda: train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                                 str(tmp_path / "run")]),
             lambda: ckpt.restore(str(tmp_path), 0, {"w": torch.zeros(2)}),
             lambda: dryrun.run_cell("llama3-8b", "train_4k", "single",
                                     layers_override=2)]
    if torch.cuda.is_available():
        assert state.create(CFG, torch.from_numpy(data)).slab.is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not state.create(CFG, torch.from_numpy(data), device="cpu"
                            ).slab.is_cuda


def test_chip_smoke_refuses_to_run_without_the_card_or_the_repo(tmp_path):
    """The smoke test exits non-zero, with no result line, on a machine
    without CUDA, and from a directory holding nothing but itself."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [alone]
    if not torch.cuda.is_available():     # with a card it would run in full
        scripts.append(ROOT / "chip_smoke.py")
    for script in scripts:
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, timeout=120, cwd=script.parent)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
