"""The port's kernels against the JAX package's Pallas kernels.

The same inputs, made from a seed with numpy, go through the Pallas kernel
in interpret mode (as tests/test_kernels.py runs it) and through the
port's plain PyTorch version, which is what ``repro_torch.kernels.ops``
runs for a CPU tensor.  The CUDA kernels themselves run only on the card
and are held against these plain versions by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.compact import compact_pages as compact_pallas
from repro.kernels.gather_objects import gather_rows as gather_pallas
from repro_torch.kernels import _build, cat_decay as tcat_decay
from repro_torch.kernels import compact as tcompact
from repro_torch.kernels import gather_objects as tgather
from repro_torch.kernels import ops, ref

RNG = np.random.RandomState(0)


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
    ops.gather_pages(pool.reshape(1, 4, 4, 8), idx)
    ops.compact_pages(pool, torch.tensor([1, -1, 2, 3], dtype=torch.int32),
                      page_objs=2)
    ops.cat_decay(torch.zeros(4, 8, dtype=torch.bool), torch.zeros(4),
                  torch.ones(4, dtype=torch.int32), decay=0.5)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgather.gather_rows(pool, idx)
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
                         ("cat_decay.cu", "cat_decay.py")]:
        src = (_build.CSRC / name).read_text()
        assert pallas in src and "Bound" in src
        assert 'extern "C"' in src
