"""The port's kernels against the JAX package's Pallas kernels.

The same inputs, made from a seed with numpy, go through the Pallas kernel
in interpret mode (as tests/test_kernels.py runs it) and through the
port's plain PyTorch version, which is what ``repro_torch.kernels.ops``
runs for a CPU tensor.  The CUDA kernels themselves run only on the card
and are held against these plain versions by ``chip_smoke.py``.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cat_update import cat_update as cat_update_pallas
from repro.kernels.compact import compact_pages as compact_pallas
from repro.kernels.gather_objects import gather_rows as gather_pallas
from repro.kernels.paged_attention import paged_attention as pattn_pallas
from repro.kernels.topk_pages import page_scores as scores_pallas
from repro_torch.kernels import _build, cat_decay as tcat_decay
from repro_torch.kernels import cat_update as tcat_update
from repro_torch.kernels import compact as tcompact
from repro_torch.kernels import gather_objects as tgather
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as tpattn
from repro_torch.kernels import topk_pages as tscores

RNG = np.random.RandomState(0)


def _chip_smoke():
    """chip_smoke.py's tolerance helpers (the script imports nothing at
    module level beyond the standard library)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(x: np.ndarray, dtype: str):
    """The same f32 numpy array as a JAX and a torch array of ``dtype``
    (both round f32 -> bf16 to nearest even)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy() if t.is_floating_point() \
            else t.numpy()
    return np.asarray(t, np.float32) if jnp.issubdtype(t.dtype, jnp.floating) \
        else np.asarray(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,r", [(16, 128, 4), (64, 256, 17), (8, 512, 8),
                                   (4096, 32, 1024)])
def test_gather_rows_matches_pallas(n, d, r, dtype):
    pool_j, pool_t = _pair(RNG.randn(n, d).astype(np.float32), dtype)
    idx = RNG.randint(-1, n, size=r).astype(np.int32)
    got = ops.gather_rows(pool_t, torch.from_numpy(idx))
    expect = gather_pallas(pool_j, jnp.asarray(idx), interpret=True)
    assert got.dtype == pool_t.dtype and tuple(got.shape) == (r, d)
    np.testing.assert_array_equal(_np(got), _np(expect))
    np.testing.assert_array_equal(
        _np(ref.gather_rows_ref(pool_t, torch.from_numpy(idx))), _np(expect))


@pytest.mark.parametrize("kvh,s,p,dh,n", [(1, 12, 8, 32, 9), (2, 6, 4, 16, 5)])
def test_gather_pages_matches_jax(kvh, s, p, dh, n):
    slab = RNG.randn(kvh, s, p, dh).astype(np.float32)
    ids = RNG.randint(-1, s, size=n).astype(np.int32)
    ids[0] = -1
    sj, st = jnp.asarray(slab), torch.from_numpy(slab)
    it = torch.from_numpy(ids)
    # masked=False: the plane's page-in call (rows at -1 are dropped later)
    np.testing.assert_array_equal(
        _np(ops.gather_pages(st, it, masked=False)),
        _np(jops.gather_pages(sj, jnp.asarray(ids), impl="ref",
                              masked=False)))
    # masked: zero pages at -1, as the Pallas kernel (interpret) gives
    got = ops.gather_pages(st, it)
    np.testing.assert_array_equal(
        _np(got), _np(jops.gather_pages(sj, jnp.asarray(ids),
                                        impl="interpret")))
    assert not got[:, 0].any()
    # with a row permutation of each fetched page
    perm = np.stack([RNG.permutation(p) for _ in range(n)]).astype(np.int32)
    np.testing.assert_array_equal(
        _np(ops.gather_pages(st, it, torch.from_numpy(perm))),
        _np(jops.gather_pages(sj, jnp.asarray(ids), jnp.asarray(perm),
                              impl="interpret")))


@pytest.mark.parametrize("f,p,d,m", [(8, 4, 128, 2), (16, 8, 256, 3),
                                     (64, 8, 32, 4)])
def test_compact_pages_matches_pallas(f, p, d, m):
    pool = RNG.randn(f * p, d).astype(np.float32)
    plan = RNG.randint(-1, f * p, size=m * p).astype(np.int32)
    got = ops.compact_pages(torch.from_numpy(pool), torch.from_numpy(plan),
                            page_objs=p)
    expect = compact_pallas(jnp.asarray(pool), jnp.asarray(plan),
                            page_objs=p, interpret=True)
    assert tuple(got.shape) == (m, p, d)
    np.testing.assert_array_equal(_np(got), _np(expect))


# gather_rows_into: (source rows, JAX destinations) per case; a JAX
# destination at or past M is dropped, the port's lands on trash row M
_M = 12
_INTO_CASES = {
    # one masked row onto the trash row, the rest distinct destinations
    "masked": ([5, -1, 31, 0, 7, 19], [3, _M, 0, 11, 6, 2]),
    # rows whose destination is out of range carry the same source row
    # (expert 0's, as the expert fetch writes its masked entries)
    "out_of_range": ([0, 8, 0, 30, 0], [_M, 4, _M + 2, 9, _M + 9]),
    "all_masked": ([-1, -1, -1, -1], [_M, _M + 1, _M, _M + 5]),
    "empty": ([], []),
    # several masked rows share the trash row
    "shared_trash": ([-1, 2, -1, -1, 17, -1], [_M, 1, _M, _M, 10, _M + 3]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_INTO_CASES))
def test_gather_rows_into_matches_jax(case, dtype):
    """ops.gather_rows_into (the plain path on the CPU) equals the JAX
    composition: the Pallas gather in interpret mode, then ``.at[dst].set``
    with out-of-range destinations dropped; the port's trash row (row M,
    which takes them) stripped before the comparison.  A trash row that
    only masked rows reach holds zeros."""
    src, dst = (np.asarray(x, np.int32) for x in _INTO_CASES[case])
    pool_j, pool_t = _pair(RNG.randn(32, 128).astype(np.float32), dtype)
    base = RNG.randn(_M, 128).astype(np.float32)
    base_j, base_t = _pair(base, dtype)
    rows = (gather_pallas(pool_j, jnp.asarray(src), interpret=True)
            if src.size else jnp.zeros((0, 128), pool_j.dtype))
    want = base_j.at[jnp.asarray(dst)].set(rows, mode="drop")
    out = torch.cat([base_t, torch.full((1, 128), 7.0, dtype=base_t.dtype)])
    got = ops.gather_rows_into(out, torch.from_numpy(np.minimum(dst, _M)),
                               pool_t, torch.from_numpy(src))
    assert got is out and out.dtype == pool_t.dtype
    np.testing.assert_array_equal(_np(out[:_M]), _np(want))
    to_trash = dst >= _M
    if to_trash.any() and (src[to_trash] < 0).all():
        assert not out[_M].any()
    elif not to_trash.any():
        assert bool((out[_M] == 7.0).all())


def _coverage(plan, n_rows: int, row_bytes: int):
    """How often the kernel's index math (row_gather.cuh) reaches each row
    and each word offset within a row under ``plan``: blocks (x, y) of
    ``lanes`` x ``THREADS // lanes`` threads, rows striding by grid_y runs,
    words by grid_x chunks.  (rows [n_rows], words [row words]) counts."""
    run = tgather.THREADS // plan.lanes
    rows = np.zeros(n_rows, np.int64)
    for by in range(plan.grid_y):
        for rb in range(by * run, n_rows, plan.grid_y * run):
            rows[rb:rb + run] += 1
    words = np.zeros(row_bytes // plan.word_bytes, np.int64)
    for bx in range(plan.grid_x):
        for x in range(plan.lanes):
            words[bx * plan.lanes + x::plan.lanes * plan.grid_x] += 1
    return rows, words


@pytest.mark.parametrize("rows,row_bytes,addr,want", [
    (1024, 128, 0, ("rows", 16, 8, 1, 32, False)),      # object rows
    (1032, 1024, 0, ("rows", 16, 64, 1, 258, False)),   # 1 KiB page rows
    (32, 128, 0, ("rows", 16, 8, 1, 1, False)),         # compact_pages
    (8, 29_360_128, 0, ("tiles", 16, 256, 66, 8, True)),   # expert fetch
    (32, 16_384, 0, ("tiles", 16, 256, 4, 32, False)),  # KV page rows
    (256, 16_384, 0, ("tiles", 16, 256, 3, 256, True)),
    (1024, 130, 0, ("rows", 1, 256, 1, 1024, False)),   # unaligned widths
    (1024, 132, 0, ("rows", 4, 64, 1, 256, False)),
    (1024, 128, 2, ("rows", 1, 128, 1, 512, False)),
    (64, 4098, 0, ("tiles", 1, 256, 9, 64, False)),
    (16, 1_000_016, 0, ("tiles", 16, 256, 33, 16, True)),
    (3, 4096, 0, ("rows", 16, 256, 1, 3, False)),
    (1, 16, 0, ("rows", 16, 1, 1, 1, False)),
    (5_000_000, 16, 0, ("rows", 16, 1, 1, 19532, True)),
    (20_000_000, 16, 0, ("rows", 16, 1, 1, 65535, True)),   # grid_y capped
])
def test_gather_launch_plan(rows, row_bytes, addr, want):
    """The geometry comes from shapes and alignment alone; every row and
    every word of a row is reached exactly once, and the grid stays within
    the card's limits."""
    word = tgather.word_bytes(row_bytes, addr)
    plan = tgather.launch_plan(rows, row_bytes, word=word)
    assert tuple(plan) == want
    assert plan.lanes & (plan.lanes - 1) == 0
    assert 1 <= plan.lanes <= tgather.THREADS
    assert 1 <= plan.grid_y <= tgather.MAX_GRID_Y and plan.grid_x >= 1
    # a row's chunks spread over at most BLOCKS_PER_SM blocks an SM
    assert (plan.grid_x - 1) * plan.grid_y < 132 * tgather.BLOCKS_PER_SM
    row_hits, word_hits = _coverage(plan, rows, row_bytes)
    assert (row_hits == 1).all() and (word_hits == 1).all()


def test_gather_launch_plan_refuses():
    with pytest.raises(ValueError):
        tgather.launch_plan(4, 130, word=4)
    with pytest.raises(ValueError):
        tgather.launch_plan(0, 128)
    with pytest.raises(ValueError):      # word offsets must fit 32 bits
        tgather.launch_plan(1, 1 << 30, word=1)


def test_gather_rows_into_refuses_bad_operands():
    """Both dispatch paths refuse a dtype or width mismatch, overlapping
    tensors and non-contiguous ones, and index vectors that are not int32
    or differ in length."""
    pool = torch.randn(8, 4)
    dst = torch.zeros(5, 4)
    i = torch.tensor([1, 2], dtype=torch.int32)
    d = torch.tensor([0, 4], dtype=torch.int32)
    ops.gather_rows_into(dst, d, pool, i)
    bad = [(dst.to(torch.bfloat16), d, pool, i, "dtype"),
           (torch.zeros(5, 3), d, pool, i, "row width"),
           (pool[2:7], d, pool[:4], i, "overlap"),
           (pool, d, pool, i, "overlap"),
           (torch.zeros(4, 5).t(), d, pool, i, "contiguous"),
           (dst, d.long(), pool, i, "int32"),
           (dst, d, pool, i.long(), "int32"),
           (dst, d[:1], pool, i, "dst_idx")]
    big = torch.zeros(20, 4)
    bad.append((big[:10], d, big[10:].clone(), i, None))   # apart: fine
    for args in bad:
        *tensors, why = args
        if why is None:
            ops.gather_rows_into(*tensors)
            continue
        with pytest.raises(ValueError, match=why):
            ops.gather_rows_into(*tensors)


@pytest.mark.parametrize("v,p,decay", [(4, 8, 0.5), (16, 32, 0.25),
                                       (5, 4, 0.9), (4096, 8, 0.3),
                                       (4096, 8, 0.7)])
def test_cat_decay_matches_jax(v, p, decay):
    """Bit-exact against ``repro.kernels.ref.cat_decay_ref`` (the version
    the JAX plane runs off the TPU): both round each product and the sum
    separately.  Against the Pallas kernel in interpret mode the agreement
    is within 1 ulp, not bit-exact: XLA:CPU contracts the kernel body's
    ``decay*ema + (1-decay)*car`` into one fused multiply-add, which skips
    the rounding of ``decay*ema`` (checked below to be the only change)."""
    cat = RNG.rand(v, p) < 0.4
    ema = RNG.rand(v).astype(np.float32)
    alloc = RNG.randint(0, p + 1, size=v).astype(np.int32)
    got = _np(ops.cat_decay(torch.from_numpy(cat), torch.from_numpy(ema),
                            torch.from_numpy(alloc), decay=decay))
    args = (jnp.asarray(cat), jnp.asarray(ema), jnp.asarray(alloc))
    ref_j = _np(jops.cat_decay(*args, decay=decay, impl="ref"))
    np.testing.assert_array_equal(got.view(np.int32), ref_j.view(np.int32))
    pallas = _np(jops.cat_decay(*args, decay=decay, impl="interpret"))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - pallas.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    car = (cat.sum(1).astype(np.float32)
           / np.maximum(alloc, 1).astype(np.float32))
    fused = (np.float64(np.float32(decay)) * ema
             + (np.float32(1.0 - decay) * car).astype(np.float64)
             ).astype(np.float32)
    np.testing.assert_array_equal(fused.view(np.int32),
                                  pallas.view(np.int32))


def test_cpu_tensors_never_reach_the_cuda_library(monkeypatch):
    """On a CPU tensor the dispatch takes the plain version and never loads
    the kernels' library; the wrappers themselves refuse CPU tensors before
    touching it."""
    def boom():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load_library", boom)
    pool = torch.randn(16, 8)
    idx = torch.tensor([3, -1, 0], dtype=torch.int32)
    ops.gather_rows(pool, idx)
    ops.gather_rows_into(torch.zeros(4, 8), torch.tensor(
        [0, 3, 3], dtype=torch.int32), pool, idx)
    ops.gather_pages(pool.reshape(1, 4, 4, 8), idx)
    ops.compact_pages(pool, torch.tensor([1, -1, 2, 3], dtype=torch.int32),
                      page_objs=2)
    ops.cat_decay(torch.zeros(4, 8, dtype=torch.bool), torch.zeros(4),
                  torch.ones(4, dtype=torch.int32), decay=0.5)
    q = torch.randn(1, 4, 8)
    summ = torch.randn(2, 4, 8)
    frames = torch.randn(2, 3, 4, 8)
    table = torch.tensor([[0, -1]], dtype=torch.int32)
    ops.page_scores(q, summ, summ)
    ops.paged_attention(q, frames, frames, table, table)
    ops.cat_update(torch.zeros(4, 1, dtype=torch.int32), idx, page_objs=8)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tscores.page_scores(q, summ, summ)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpattn.paged_attention(q, frames, frames, table, table)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tcat_update.cat_update(torch.zeros(4, 1, dtype=torch.int32), idx,
                               page_objs=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgather.gather_rows(pool, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgather.gather_rows_into(torch.zeros(4, 8), idx, pool, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tcompact.compact_pages(pool, idx[:2], page_objs=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tcat_decay.cat_decay(torch.zeros(4, 8, dtype=torch.bool),
                             torch.zeros(4), torch.ones(4, dtype=torch.int32),
                             decay=0.5)
    assert ops.launch_counts() == before


def test_kernel_build_is_keyed_by_sources():
    """The build hashes every source and header it compiles, and each
    source says which Pallas kernel it replaces."""
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    for name, pallas in [("gather_rows.cu", "gather_objects.py"),
                         ("compact_pages.cu", "compact.py"),
                         ("cat_decay.cu", "cat_decay.py"),
                         ("page_scores.cu", "topk_pages.py"),
                         ("paged_attention.cu", "paged_attention.py"),
                         ("cat_update.cu", "cat_update.py")]:
        assert name in _build.SOURCES
        src = (_build.CSRC / name).read_text()
        assert pallas in src and "Bound" in src
        assert 'extern "C"' in src


# --------------------------------------------------------------------------
# the KV plane's kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kvh,g,dh,npg", [(2, 2, 4, 128, 128),
                                            (1, 4, 2, 64, 256),
                                            (3, 1, 1, 8, 16)])
def test_page_scores_matches_pallas(b, kvh, g, dh, npg, qdtype):
    """The plain version against ``repro.kernels.ref`` and the Pallas body
    in interpret mode, within 1e-5 (relative to the largest score): the
    sums over Dh run in other orders."""
    q_j, q_t = _pair(RNG.randn(b, kvh * g, dh).astype(np.float32), qdtype)
    kmax = RNG.randn(kvh, npg, dh).astype(np.float32)
    kmin = kmax - np.abs(RNG.randn(kvh, npg, dh)).astype(np.float32)
    got = _np(ops.page_scores(q_t, torch.from_numpy(kmax),
                              torch.from_numpy(kmin)))
    want_ref = _np(jref.page_scores_ref(q_j, jnp.asarray(kmax),
                                        jnp.asarray(kmin)))
    want_pallas = _np(scores_pallas(q_j.reshape(b, kvh, g, dh),
                                    jnp.asarray(kmax), jnp.asarray(kmin),
                                    block_pages=min(128, npg),
                                    interpret=True))
    assert got.shape == (b, kvh, npg)
    tol = 1e-5 * np.abs(want_ref).max()
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=tol)


def test_page_scores_unwritten_pages_are_nan():
    """An unwritten page (kmax -inf, kmin +inf) scores +inf, and NaN where
    a q_d is 0, in both packages: the plane masks those pages."""
    q = np.ones((1, 2, 8), np.float32)
    q[0, 1, 3] = 0.0
    kmax = np.full((1, 3, 8), -np.inf, np.float32)
    kmin = np.full((1, 3, 8), np.inf, np.float32)
    kmax[0, 0], kmin[0, 0] = 1.0, -1.0
    got = _np(ops.page_scores(torch.from_numpy(q), torch.from_numpy(kmax),
                              torch.from_numpy(kmin)))
    want = _np(jref.page_scores_ref(jnp.asarray(q), jnp.asarray(kmax),
                                    jnp.asarray(kmin)))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 0, 1:]).all() and got[0, 0, 0] == 8.0


def _paged_inputs(b, kvh, g, dh, f, p, npg, empty):
    q = RNG.randn(b, kvh * g, dh).astype(np.float32)
    k = RNG.randn(kvh, f, p, dh).astype(np.float32)
    v = RNG.randn(kvh, f, p, dh).astype(np.float32)
    pt = np.full((b, npg), -1, np.int32)
    pl_ = np.zeros((b, npg), np.int32)
    for i in range(b):
        if i in empty:
            continue
        n = RNG.randint(1, npg + 1)
        pt[i, :n] = RNG.choice(f, n, replace=False)
        pl_[i, :n] = RNG.randint(1, p + 1, size=n)
    return q, k, v, pt, pl_


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kvh,g,dh,f,p,npg", [(2, 2, 4, 128, 16, 16, 8),
                                                (3, 1, 2, 64, 8, 8, 4),
                                                (2, 4, 1, 8, 4, 4, 3),
                                                (2, 1, 48, 128, 6, 8, 4),
                                                (2, 1, 8, 256, 6, 8, 4)])
def test_paged_attention_matches_pallas(b, kvh, g, dh, f, p, npg, dtype):
    """The plain version against the Pallas body in interpret mode (out
    within 2e-5 in f32 and 2e-2 in bf16, as tests/test_kernels.py holds
    them; ``used`` equal), with the last sequence holding no valid row:
    both give 0 there, where ``repro.kernels.ref`` gives NaN.  The other
    sequences also match ``repro.kernels.ref``."""
    q, k, v, pt, pl_ = _paged_inputs(b, kvh, g, dh, f, p, npg, {b - 1})
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (q, k, v))
    out, used = ops.paged_attention(qt, kt, vt, torch.from_numpy(pt),
                                    torch.from_numpy(pl_))
    assert out.dtype == qt.dtype and used.dtype == torch.bool
    okr, ukr = pattn_pallas(qj.reshape(b, kvh, g, dh), kj, vj,
                            jnp.asarray(pt).reshape(-1),
                            jnp.asarray(pl_).reshape(-1), interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(okr).reshape(b, kvh * g, dh),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(used.numpy(),
                                  np.asarray(ukr).astype(bool).any(axis=1))
    assert not _np(out)[b - 1].any() and not used[b - 1].any()
    oref, uref = jref.paged_attention_ref(qj, kj, vj, jnp.asarray(pt),
                                          jnp.asarray(pl_))
    assert np.isnan(_np(oref)[b - 1]).all()
    np.testing.assert_allclose(_np(out)[:b - 1], _np(oref)[:b - 1],
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(used.numpy(), np.asarray(uref))


CAT_CASES = [(16, 8, 24, 0), (8, 64, 40, 0), (5, 33, 12, 0),
             (4096, 8, 1024, 0), (16, 8, 24, 3), (5, 33, 12, 3),
             (4, 8, 200, 3), (3, 8200 * 32, 64, 3),
             (2, 8193 * 32 - 5, 64, 1)]


def _cat_inputs(v, p, r, past):
    """Words with every bit a page can hold drawn (the top bit of a full
    word set makes it negative as int32), and r vaddrs from -1 to ``past``
    pages beyond the last, a quarter of them duplicates."""
    w = -(-p // 32)
    bits = RNG.randint(0, 2 ** 32, size=(v, w), dtype=np.uint64)
    bits &= np.uint64(2 ** p - 1 if p < 32 else 2 ** 32 - 1)
    bits = bits.astype(np.uint32)
    vaddrs = RNG.randint(-1, (v + past) * p, size=r).astype(np.int32)
    vaddrs[: r // 4] = vaddrs[r // 4: r // 2]        # duplicates
    return bits, vaddrs


@pytest.mark.parametrize(
    "v,p,r,past", CAT_CASES,
    ids=[f"{v}-{p}-{r}" + (f"-past{k}" if k else "")
         for v, p, r, k in CAT_CASES])
def test_cat_update_matches_pallas(v, p, r, past):
    """Bits and CAR equal ``repro.kernels.ref`` and the Pallas body in
    interpret mode, with duplicate touches, skipped (-1) ones, touches up
    to ``past`` pages beyond the last (dropped), and words whose top bit is
    set (negative as int32).  At (4, 8, 200) the touches outnumber the
    pages' cards and every page is touched.  The last two take pages
    wider than the kernel's chunk of 8,192 words (8,200 words; 8,193 with
    a ragged last word), which it splits over blocks."""
    bits, vaddrs = _cat_inputs(v, p, r, past)
    got_bits, got_car = ops.cat_update(torch.from_numpy(bits.view(np.int32)),
                                       torch.from_numpy(vaddrs), page_objs=p)
    assert got_bits.dtype == torch.int32
    jb, jc = jops.cat_update(jnp.asarray(bits), jnp.asarray(vaddrs),
                             page_objs=p, impl="ref")
    pb, pc = jops.cat_update(jnp.asarray(bits), jnp.asarray(vaddrs),
                             page_objs=p, impl="interpret")
    for want_b, want_c in ((jb, jc), (pb, pc)):
        np.testing.assert_array_equal(got_bits.numpy().view(np.uint32),
                                      np.asarray(want_b))
        np.testing.assert_array_equal(got_car.numpy(), np.asarray(want_c))
    if past:
        assert (vaddrs >= v * p).any()
    if r > 8 * v * p:
        touched = np.unique(vaddrs[(vaddrs >= 0) & (vaddrs < v * p)] // p)
        assert touched.size == v


@pytest.mark.parametrize("p", [8, 40])
def test_cat_update_without_touches(p):
    """R = 0 returns the words unchanged with their CAR, held against a
    numpy popcount (JAX's ``cat_update_ref`` indexes the empty touch list
    and raises IndexError)."""
    bits, _ = _cat_inputs(12, p, 0, 0)
    got_bits, got_car = ops.cat_update(
        torch.from_numpy(bits.view(np.int32)),
        torch.empty((0,), dtype=torch.int32), page_objs=p)
    np.testing.assert_array_equal(got_bits.numpy().view(np.uint32), bits)
    want = (np.bitwise_count(bits).sum(axis=1).astype(np.float32)
            / np.float32(p))
    np.testing.assert_array_equal(got_car.numpy(), want)


def test_lengths_to_page_lens_matches_jax():
    lengths = np.asarray([0, 1, 7, 8, 9, 31, 40], np.int32)
    np.testing.assert_array_equal(
        ops.lengths_to_page_lens(torch.from_numpy(lengths), 5, 8).numpy(),
        np.asarray(jops.lengths_to_page_lens(jnp.asarray(lengths), 5, 8)))


def _mma_emulation(q, k, v, pt, pl, splits, per, teams):
    """The tensor-core path's arithmetic in plain PyTorch: per team an
    online softmax in base 2 over its pages (scores q.k in f32, scaled
    after the product), p rounded to bf16 before P.V while l and the card
    signal take the f32 p, the teams and then the splits combined in
    order, the output rounded to q's dtype."""
    B, H, Dh = q.shape
    KVH, F, P, _ = k.shape
    NP = pt.shape[1]
    G = H // KVH
    f32 = torch.float32
    scale2 = (torch.tensor(1.0 / math.sqrt(Dh), dtype=f32)
              * torch.tensor(1.4426950408889634, dtype=f32))
    qf = q.to(f32).view(B, KVH, G, Dh)
    used = torch.zeros((B, NP, P), dtype=torch.bool)
    rowi = torch.arange(P)

    def combine(parts):
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
        for m, lp, ap in parts:
            w = torch.exp2(m - mx)
            l, acc = l + w * lp, acc + w[..., None] * ap
        return mx, l, acc

    splits_out = []
    for sp in range(splits):
        team_parts = []
        for t in range(teams):
            m = torch.full((B, KVH, G), -1e30, dtype=f32)
            l = torch.zeros((B, KVH, G), dtype=f32)
            acc = torch.zeros((B, KVH, G, Dh), dtype=f32)
            for j in range(sp * per + t, min(NP, (sp + 1) * per), teams):
                frame, rows = pt[:, j].long(), pl[:, j].clamp(max=P)
                live = (frame >= 0) & (rows > 0)
                kp = k[:, frame.clamp(min=0)].to(f32).transpose(0, 1)
                vp = v[:, frame.clamp(min=0)].to(f32).transpose(0, 1)
                valid = (rowi[None] < rows[:, None]) & live[:, None]
                vm = valid[:, None, None]
                s = torch.einsum("bkgd,bkpd->bkgp", qf, kp) * scale2
                s = torch.where(vm, s, torch.tensor(-1e30))
                mn = torch.maximum(m, s.amax(-1))
                al = torch.exp2(m - mn)
                p = torch.where(vm, torch.exp2(s - mn[..., None]), 0.0)
                mass = p.sum(-1)
                used[:, j] |= (p * P > mass[..., None]).any(2).any(1) & valid
                pv = torch.einsum("bkgp,bkpd->bkgd",
                                  p.to(torch.bfloat16).to(f32), vp)
                up = live[:, None, None]
                m = torch.where(up, mn, m)
                l = torch.where(up, al * l + mass, l)
                acc = torch.where(up[..., None], al[..., None] * acc + pv,
                                  acc)
            team_parts.append((m, l, acc))
        splits_out.append(combine(team_parts))
    _, l, acc = combine(splits_out)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype), used


@pytest.mark.parametrize("b,kvh,splits,per,teams", [(1, 8, 16, 4, 4),
                                                    (3, 2, 1, 64, 1)])
def test_paged_attention_mma_rounding_within_tolerance(b, kvh, splits, per,
                                                       teams):
    """The tensor-core path's rounding (p in bf16 for P.V, l and the card
    signal from the f32 p, base-2 exponentials) stays within chip_smoke's
    unchanged ``attention_tol`` of the plain version at decode-like shapes
    (G=4, Dh=128, P=64, 64 pages, bf16): the long_500k sparse split
    (16 splits x 4 teams) and an unsplit dense block; ``used`` equal except
    on rows within rounding of the threshold, as chip_smoke counts them."""
    smoke = _chip_smoke()
    g, dh, p, npg, f = 4, 128, 64, 64, 80
    q = torch.from_numpy(RNG.randn(b, kvh * g, dh).astype(np.float32)).to(
        torch.bfloat16)
    k = torch.from_numpy(RNG.randn(kvh, f, p, dh).astype(np.float32)).to(
        torch.bfloat16)
    v = torch.from_numpy(RNG.randn(kvh, f, p, dh).astype(np.float32)).to(
        torch.bfloat16)
    pt = np.stack([RNG.choice(f, npg, replace=False) for _ in range(b)])
    pl_ = np.full((b, npg), p)
    pt[0, 5], pl_[0, 7], pl_[-1, 9] = -1, 17, 0          # gaps and a partial
    pt, pl_ = (torch.from_numpy(x.astype(np.int32)) for x in (pt, pl_))
    assert tpattn.kernel_path(q.dtype, k.dtype, g, dh, p) == "mma"
    out, used = _mma_emulation(q, k, v, pt, pl_, splits, per, teams)
    oref, uref = ref.paged_attention_ref(q, k, v, pt, pl_)
    tol = smoke.attention_tol(torch, oref)
    assert float((out.float() - oref.float()).abs().max()) <= tol
    border = smoke.used_borderline(torch, q, k, v, pt, pl_)
    assert not bool(((used != uref) & ~border).any())
    assert bool(uref.any())


def test_paged_attention_path_choice():
    """The wrapper picks its path from dtypes and shapes alone: every bf16
    configuration of the repo (llama3-8b's G=4/Dh=128/P=64, granite-20b's
    G=48, paligemma-3b's Dh=256) takes the tensor cores; f32, mixed
    dtypes, Dh=8 and bf16 pages of 128 rows take the CUDA cores; G=48 in
    f32 and shapes neither path takes raise."""
    bf, f32 = torch.bfloat16, torch.float32
    path = tpattn.kernel_path
    assert path(bf, bf, 4, 128, 64) == "mma"
    assert path(bf, bf, 48, 128, 64) == "mma"
    assert path(bf, bf, 8, 256, 64) == "mma"
    assert path(bf, bf, 64, 256, 16) == "mma"
    assert path(f32, f32, 4, 128, 64) == "cuda_core"
    assert path(bf, f32, 4, 128, 64) == "cuda_core"
    assert path(f32, bf, 4, 128, 64) == "cuda_core"
    assert path(bf, bf, 4, 8, 64) == "cuda_core"
    assert path(bf, bf, 2, 256, 128) == "cuda_core"
    for args in [(f32, f32, 48, 128, 64), (bf, bf, 65, 128, 64),
                 (bf, bf, 4, 264, 64), (bf, bf, 16, 128, 128),
                 (torch.float16, torch.float16, 4, 128, 64)]:
        with pytest.raises(ValueError):
            path(*args)


def test_paged_attention_mma_launch_plan():
    """The tensor-core path's blocks: one warp per 16 query heads; one team
    a block over all of a pair's pages when the pairs fill the card (the
    decode_32k batch), otherwise up to four teams a block and the pages
    split so the blocks fill every SM once (the long_500k sparse step: one
    page a warp); every block within the card's threads and shared memory,
    and every page in exactly one split."""
    plan = tpattn.launch_plan
    sms = 132                                                # H100 SXM
    assert plan("mma", 8, 64, sms, 4, 128, 64) == (16, 4, 1, 4)
    assert plan("mma", 1024, 512, sms, 4, 128, 64) == (1, 512, 1, 1)
    assert plan("mma", 160, 6, sms, 4, 128, 64) == (1, 6, 1, 1)
    assert plan("mma", 32, 512, sms, 48, 128, 64) == (8, 64, 3, 2)
    assert plan("mma", 32, 512, sms, 8, 256, 64) == (4, 128, 1, 2)
    assert plan("cuda_core", 8, 64, sms, 4, 128, 64) == (16, 4, 0, 0)
    for pairs, n, g, dh, p in [(8, 64, 4, 128, 64), (2, 6, 48, 128, 64),
                               (3, 7, 64, 256, 64), (1, 1000, 1, 16, 16),
                               (100, 3, 20, 96, 40), (131, 512, 8, 256, 64)]:
        s, per, mt, teams = plan("mma", pairs, n, sms, g, dh, p)
        assert s * per >= n and (s - 1) * per < n
        assert 16 * mt >= g > 16 * (mt - 1) and 32 * mt * teams <= 256
        assert tpattn._mma_stage_bytes(mt, teams, dh, p) <= tpattn.MMA_SMEM
        assert teams == 1 or s > 1


def test_paged_attention_split_rule():
    """Pages split over blocks (flash-decoding) only when the (sequence,
    kv head) pairs cannot fill the card: every page lands in one split."""
    sms = 132                                          # H100 SXM
    assert tpattn.split_pages(8, 64, sms) == (16, 4)       # sparse: 8 pairs
    assert tpattn.split_pages(1024, 512, sms) == (1, 512)  # dense: 1024 pairs
    assert tpattn.split_pages(160, 4, sms) == (1, 4)       # 40 x 4 pairs
    assert tpattn.split_pages(8, 64, 114) == (13, 5)       # H100 PCIe
    for pairs, n in [(2, 100), (3, 7), (100, 1000)]:
        s, per = tpattn.split_pages(pairs, n, sms)
        assert s * per >= n and (s - 1) * per < n
