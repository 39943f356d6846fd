"""Fault-tolerant checkpointing (port of ``repro.checkpoint.ckpt``), in
the JAX package's on-disk format:

  * each leaf -> one ``.npy`` file ``f"{i:05d}_{name[:80]}.npy"`` under
    ``step_<N>.tmp/``, the leaves in ``jax.tree_util``'s order (dict keys
    sorted) and named by their path as JAX names them
  * ``manifest.json`` records the step, each leaf's file, shape and dtype,
    and ``extra``
  * the tmp dir is renamed to ``step_<N>/`` (a crash mid-write never
    leaves a partial checkpoint that ``latest()`` would pick)
  * ``AsyncCheckpointer`` copies the tree to the host before it returns and
    writes on a background thread

A tree of the same structure is readable by either package.  The port's
model parameters keep a list of layers where JAX stacks them, so a port
checkpoint of parameters has per-layer leaves (``convert`` bridges the two
layouts).  A bf16 leaf is written as numpy writes JAX's (``<V2``, the raw
bits; the manifest says ``bfloat16``) and read back as bf16.  With
``mesh`` and ``spec_tree`` a restore lays each leaf out on the mesh by its
spec (``launch.mesh.distribute``): a restart may use another mesh than
the writer.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.state import resolve_device
from ..launch import mesh as mesh_lib
from ..tree import flatten_with_path, tree_map, unflatten


def _flatten_with_paths(tree):
    out = []
    for path, leaf in flatten_with_path(tree):
        name = "_".join(str(p) for p in path) or "leaf"
        out.append((name.replace("/", "_").replace("'", ""), leaf))
    return out


def _save_leaf(path: str, leaf) -> tuple[list, str]:
    """Writes one leaf; returns (shape, manifest dtype).  A bf16 tensor is
    written as numpy writes an ml_dtypes bf16 array: its bits under the
    header descr ``<V2``."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        bits = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": bits.shape})
            f.write(bits.tobytes())
        return list(bits.shape), "bfloat16"
    arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None):
    """Synchronous atomic save."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(_flatten_with_paths(tree)):
        fname = f"{i:05d}_{name[:80]}.npy"
        shape, dtype = _save_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append(
            {"file": fname, "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic publish
    return final


def latest(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template: Any, *, device="cuda",
            mesh=None, spec_tree=None) -> Any:
    """Load a checkpoint into ``template``'s tree structure, every leaf a
    tensor on ``device``; with ``mesh`` and ``spec_tree`` (a spec tree of
    the template's structure) every leaf a DTensor on ``mesh`` laid out by
    its spec.  Returns (tree, extra)."""
    if (mesh is None) != (spec_tree is None):
        raise ValueError("restore onto a mesh needs both mesh and spec_tree")
    dev = resolve_device(mesh.device_type if mesh is not None else device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = [_from_numpy(np.load(os.path.join(path, rec["file"])),
                          rec["dtype"], dev) for rec in manifest["leaves"]]
    tree = unflatten(template, arrays)
    if mesh is not None:
        tree = mesh_lib.distribute_tree(tree, mesh, spec_tree)
    return tree, manifest.get("extra", {})


def prune(ckpt_dir: str, keep: int = 3):
    """Drop all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(s for s in (
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (one in flight; a new save waits
    for the one before)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             block: bool = False):
        # a copy on the host BEFORE returning: the caller updates the
        # tensors in place at its next step (``.cpu()`` of a CPU tensor is
        # the tensor itself, hence the explicit copy)
        host_tree = tree_map(lambda x: torch.as_tensor(x).detach().to(
            "cpu", copy=True), tree)
        self.wait()

        def work():
            save(self.dir, step, host_tree, extra=extra)
            prune(self.dir, self.keep)

        with self._lock:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        if block:
            self.wait()

    def wait(self):
        t = self._thread
        if t is not None and t.is_alive():
            t.join()
