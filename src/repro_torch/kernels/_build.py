"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``.  The build
runs at first use, into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), and is keyed by a hash of the sources and
flags: an edited source rebuilds, an unchanged one loads the cached
library.  Nothing here runs at import time, so the CPU tests, which never
launch a kernel, import the package without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gather_rows.cu", "compact_pages.cu", "cat_decay.cu",
           "page_scores.cu", "paged_attention.cu", "cat_update.cu")
HEADERS = ("row_gather.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""          # nvcc's output (ptxas register/spill report)
build_seconds = 0.0     # wall time of the last build (0 when cached)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch kernels: nvcc not found (CUDA_HOME or "
                       "PATH); the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if the cached library is stale) and return the
    shared library's path."""
    global build_log, build_seconds
    so = BUILD_DIR / f"libreprokernels-{source_hash()}.so"
    if so.exists():
        return so
    t0 = time.time()
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{so.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"--- {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp_so = work / so.name
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp_so), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_so, so)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.time() - t0
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.repro_gather_rows, lib.repro_compact_pages):
            # (device, pool, n_pool, idx, n_rows, out, row_bytes, stream)
            fn.argtypes = [I32, P, I64, P, I64, P, I64, P]
            fn.restype = I32
        # (device, cat, ema, alloc, out, n_pages, page_objs, decay, keep, stream)
        lib.repro_cat_decay.argtypes = [I32, P, P, P, P, I64, I32,
                                        ctypes.c_float, ctypes.c_float, P]
        lib.repro_cat_decay.restype = I32
        # (device, q, q_bf16, kmax, kmin, out, B, KVH, G, NP, Dh, stream)
        lib.repro_page_scores.argtypes = [I32, P, I32, P, P, P, I64, I32,
                                          I32, I32, I32, P]
        lib.repro_page_scores.restype = I32
        # (device, q, q_bf16, k, v, kv_bf16, page_table, page_lens, out,
        #  used, m_part, l_part, acc_part, B, KVH, G, Dh, F, P, NP, splits,
        #  pages_per_split, scale, stream)
        lib.repro_paged_attention.argtypes = [
            I32, P, I32, P, P, I32, P, P, P, P, P, P, P, I64, I32, I32, I32,
            I64, I32, I32, I32, I32, ctypes.c_float, P]
        lib.repro_paged_attention.restype = I32
        # (device, q, k, v, page_table, page_lens, out, used, m_part,
        #  l_part, acc_part, counters, B, KVH, G, Dh, F, P, NP, splits,
        #  pages_per_split, m_tiles, teams, scale, stream)
        lib.repro_paged_attention_mma.argtypes = [
            I32, P, P, P, P, P, P, P, P, P, P, P, I64, I32, I32, I32, I64,
            I32, I32, I32, I32, I32, I32, ctypes.c_float, P]
        lib.repro_paged_attention_mma.restype = I32
        # (device, bits_in, vaddrs, bits_out, car, V, W, R, page_objs, stream)
        lib.repro_cat_update.argtypes = [I32, P, P, P, P, I64, I32, I64, I32,
                                         P]
        lib.repro_cat_update.restype = I32
        lib.repro_error_string.argtypes = [I32]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load_library().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def require_cuda(name: str, **tensors) -> int:
    """Check that every tensor is a contiguous CUDA tensor on one device;
    return that device's index.  A kernel wrapper calls this first, so a
    CPU tensor is refused before the library is ever loaded."""
    dev = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device} (CPU tensors take the plain "
                             f"version through repro_torch.kernels.ops)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    return dev.index if dev.index is not None else 0


def stream_ptr(device_index: int) -> int:
    """The current PyTorch stream of a device, as a pointer for ctypes."""
    return torch.cuda.current_stream(device_index).cuda_stream
