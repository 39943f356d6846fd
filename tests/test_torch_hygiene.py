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
from repro_torch.launch import serve, train
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


def test_port_package_is_complete():
    """Every module of the slice exists beside its JAX counterpart."""
    port, jaxpkg = ROOT / "src" / "repro_torch", ROOT / "src" / "repro"
    for mod in ("core/layout.py", "core/state.py", "core/faults.py",
                "core/paths.py", "core/batch.py", "core/plane.py",
                "kernels/ref.py", "kernels/ops.py", "kernels/gather_objects.py",
                "kernels/compact.py", "kernels/cat_decay.py",
                "kernels/topk_pages.py", "kernels/paged_attention.py",
                "kernels/cat_update.py", "core/kvplane.py",
                "data/kvworkload.py", "serving/engine.py", "launch/serve.py",
                "core/expertplane.py", "models/common.py",
                "models/attention.py", "models/mlp.py", "models/lm.py",
                "models/api.py", "configs/__init__.py",
                "core/shardplane.py", "launch/mesh.py", "models/ssm.py",
                "models/encdec.py", "optim/__init__.py",
                "optim/optimizers.py", "optim/schedules.py",
                "optim/accumulation.py", "optim/compression.py",
                "data/synthetic.py", "data/pipeline.py",
                "checkpoint/ckpt.py", "runtime/orchestrator.py",
                "launch/train.py"):
        assert (port / mod).exists(), mod
        assert (jaxpkg / mod).exists(), mod
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
             lambda: ckpt.restore(str(tmp_path), 0, {"w": torch.zeros(2)})]
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
