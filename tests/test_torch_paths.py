"""The reference's public helpers that no path of either package calls,
against the JAX functions on seeded inputs, bit for bit:

* ``core.paths.page_in`` (the paging path as one operation: a frame from
  ``alloc_frame``, evicting its victim when the pool is full) and
  ``object_in`` (the runtime path as one operation, through enough fetches
  that the ingress fill page rolls over), every field of the plane state;
* ``core.layout.vaddr_of``/``split_vaddr``;
* ``kernels.ref.scatter_rows_ref``/``compact_rows_ref``, negative entries
  included (JAX writes row or frame 0's old value back, after any earlier
  write there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jlayout
from repro.core import paths as jpaths
from repro.core import plane as jplane
from repro.core import state as jstate
from repro.core.layout import PlaneConfig as JConfig
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import layout as tlayout
from repro_torch.core import paths as tpaths
from repro_torch.core import plane as tplane
from repro_torch.core import state as tstate
from repro_torch.core.layout import PlaneConfig
from repro_torch.kernels import ref as tref

KW = dict(num_objs=96, obj_dim=4, page_objs=8, num_frames=6, num_vpages=40)


def _same(js, ts, ctx):
    a = jax.device_get(js)._asdict()
    b = convert.state_to_numpy(ts)
    for k, x in a.items():
        if k == "stats":
            for kk, vv in x._asdict().items():
                np.testing.assert_array_equal(np.asarray(vv), b[k][kk],
                                              err_msg=f"stats.{kk} {ctx}")
            continue
        x = np.asarray(x)
        assert x.dtype == b[k].dtype, (k, ctx)
        np.testing.assert_array_equal(x, b[k], err_msg=f"{k} {ctx}")


def _planes(warm: int):
    """Both packages' plane over the same data, after ``warm`` batches of
    seeded accesses (enough to fill the frame pool)."""
    jc, tc = JConfig(kernel_impl="ref", **KW), PlaneConfig(**KW)
    data = np.random.RandomState(0).randn(96, 4).astype(np.float32)
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    acc = jax.jit(functools.partial(jplane.access, jc))
    rng = np.random.RandomState(1)
    for _ in range(warm):
        ids = rng.randint(0, 96, 16).astype(np.int32)
        js, _ = acc(js, jnp.asarray(ids))
        tplane.access(tc, ts, torch.from_numpy(ids))
    _same(js, ts, "after the warm-up")
    return jc, tc, js, ts


@pytest.mark.parametrize("warm", [0, 6])
def test_page_in_matches_jax(warm):
    """Remote pages paged in one by one: into free frames (warm 0) and,
    with the pool full, each through an eviction."""
    jc, tc, js, ts = _planes(warm)
    if warm:
        assert int((ts.vpage_of[:tc.num_frames] >= 0).sum()) == tc.num_frames
    f = jax.jit(functools.partial(jpaths.page_in, jc))
    remote = [v for v in range(tc.data_pages)
              if int(ts.backing[v]) == jlayout.REMOTE][:5]
    assert len(remote) >= 3
    for v in remote:
        js = f(js, jnp.int32(v))
        tpaths.page_in(tc, ts, torch.tensor(v, dtype=torch.int32))
        _same(js, ts, f"after page_in({v})")


def test_object_in_matches_jax():
    """Objects of remote pages fetched one by one onto the ingress fill
    page, past the page's 8 slots (the fill page rolls over)."""
    jc, tc, js, ts = _planes(4)
    f = jax.jit(functools.partial(jpaths.object_in, jc))
    P = tc.page_objs
    objs = [o for o in range(tc.num_objs)
            if int(ts.backing[int(ts.obj_loc[o]) // P]) == jlayout.REMOTE]
    objs = objs[::3][:P + 3]
    assert len(objs) == P + 3
    fills = set()
    for o in objs:
        js = f(js, jnp.int32(o))
        tpaths.object_in(tc, ts, torch.tensor(o, dtype=torch.int32))
        fills.add(int(ts.fill_vpage))
        _same(js, ts, f"after object_in({o})")
    assert len(fills) >= 2, "the fill page never rolled over"


def test_vaddr_helpers_match_jax():
    v = np.array([0, 1, 5, 39], np.int32)
    slot = np.array([0, 7, 3, 1], np.int32)
    va = jlayout.vaddr_of(jnp.asarray(v), jnp.asarray(slot), 8)
    tva = tlayout.vaddr_of(torch.from_numpy(v), torch.from_numpy(slot), 8)
    np.testing.assert_array_equal(np.asarray(va), tva.numpy())
    for a, b in zip(jlayout.split_vaddr(va, 8), tlayout.split_vaddr(tva, 8)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tlayout.split_vaddr(tlayout.vaddr_of(5, 3, 8), 8) == (5, 3)


@pytest.mark.parametrize("idx", [[3, -1, 0, 5, -1], [-1, 0, 2], [0, -1],
                                 [4, 1, 6]])
def test_scatter_rows_ref_matches_jax(idx):
    rng = np.random.RandomState(2)
    pool = rng.randn(8, 5).astype(np.float32)
    rows = rng.randn(len(idx), 5).astype(np.float32)
    idx = np.array(idx, np.int32)
    want = jref.scatter_rows_ref(jnp.asarray(pool), jnp.asarray(idx),
                                 jnp.asarray(rows))
    got = tref.scatter_rows_ref(torch.from_numpy(pool), torch.from_numpy(idx),
                                torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("dst", [[2, -1, 5], [0, -1, 3], [-1, 0, 4],
                                 [1, 3, 5]])
def test_compact_rows_ref_matches_jax(dst):
    rng = np.random.RandomState(3)
    F, P, D = 6, 4, 3
    frames = rng.randn(F, P, D).astype(np.float32)
    src = rng.randint(-1, F * P, (len(dst), P)).astype(np.int32)
    dst = np.array(dst, np.int32)
    want = jref.compact_rows_ref(jnp.asarray(frames), jnp.asarray(src),
                                 jnp.asarray(dst), None)
    got = tref.compact_rows_ref(torch.from_numpy(frames),
                                torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
