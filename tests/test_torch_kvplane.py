"""The port's KV serve plane against the JAX ``repro.core.kvplane``.

Each scenario builds the same config and the same seeded numpy inputs in
both packages, carries the JAX state to the port (``convert``), steps both,
and compares: every int, bool and frame field bit for bit, outputs within
1e-5 in f32.  On the CPU the port's kernels take their plain versions, as
the JAX plane takes its ``ref`` versions off the TPU.  Where a scenario
depends on the top-K page selection, it first asserts that the scores of
the selected pages stand apart by more than 1e-4 (relative), so a rounding
tie fails as a tie and not as a fault of the port.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import kvplane as jkv
from repro.kernels.paged_attention import paged_attention as pattn_pallas
from repro_torch import convert
from repro_torch.core import faults as tfaults
from repro_torch.core import kvplane as tkv
from repro_torch.kernels import ref

TOL = 1e-5


def _cfgs(faults=None, **kw):
    """The same KV plane config in both packages (f32)."""
    jc = jkv.KVPlaneConfig(dtype=jnp.float32, faults=None if faults is None
                           else jfaults.Schedule(**faults), **kw)
    tc = tkv.KVPlaneConfig(dtype=torch.float32, faults=None if faults is None
                           else tfaults.Schedule(**faults), **kw)
    return jc, tc


def _to_port(tcfg, js):
    return convert.kv_state_from_numpy(tcfg, jax.device_get(js), "cpu")


def _prefill(jcfg, seed, magnet=True):
    """A fully written far tier with optional magnet rows (skewed
    attention: PSF flips to runtime and packed fetches), as
    tests/test_batch_equivalence.py builds it."""
    rng = np.random.RandomState(seed)
    s = jkv.init(jcfg)
    KVH, P, Dh = jcfg.kv_heads, jcfg.page_tokens, jcfg.head_dim
    pages = jcfg.batch * jcfg.num_pages
    k = rng.randn(KVH, pages, P, Dh).astype(np.float32)
    if magnet:
        k[:, 3, 2] = 4.0
        k[:, pages // 2, 1] = -4.0
    v = rng.randn(KVH, pages, P, Dh).astype(np.float32)
    return s._replace(k_slab=jnp.asarray(k), v_slab=jnp.asarray(v),
                      kmax=jnp.asarray(k.max(axis=2)),
                      kmin=jnp.asarray(k.min(axis=2)))


def assert_same_state(tcfg, ts, js, ctx=""):
    got = convert.kv_state_to_numpy(tcfg, ts)
    for name, want in jax.device_get(js)._asdict().items():
        np.testing.assert_array_equal(
            got[name], np.asarray(want, got[name].dtype),
            err_msg=f"KVPlaneState.{name} differs {ctx}")


def assert_close(t_out, j_out, ctx=""):
    np.testing.assert_allclose(t_out.to(torch.float32).numpy(),
                               np.asarray(j_out, np.float32), rtol=TOL,
                               atol=TOL, err_msg=ctx)


def assert_selection_apart(tcfg, ts, q, n_valid):
    """The top-K+1 page scores of every sequence differ pairwise (in rank
    order) by more than 1e-4 relative: the selection and its order do not
    rest on rounding."""
    B, NP, K = tcfg.batch, tcfg.num_pages, tcfg.sparse_topk
    sc = ref.page_scores_ref(q, ts.kmax, ts.kmin).amax(dim=1)
    sc = sc.view(B, B, NP)[torch.arange(B), torch.arange(B)]
    for b in range(B):
        n = int(n_valid[b])
        top = torch.sort(sc[b, :n], descending=True).values[:K + 1]
        gaps = (top[:-1] - top[1:]).abs()
        scale = top.abs()[:-1].clamp_min(1.0)
        assert bool((gaps > 1e-4 * scale).all()), \
            f"selection within rounding of a tie: {top.tolist()}"


def assert_shards_apart(tcfg, states, q, length):
    """``assert_selection_apart`` on each shard's own valid pages."""
    P, NP = tcfg.page_tokens, tcfg.num_pages
    for d, s in enumerate(states):
        n = min(max(-(-(length - d * NP * P) // P), 0), NP)
        if n:
            assert_selection_apart(tcfg, s, q, [n])


def _naive_attn(q, K, V, G):
    H, Dh = q.shape
    out = np.zeros((H, Dh))
    for h in range(H):
        sc = (K[:, h // G] @ q[h]) / np.sqrt(Dh)
        w = np.exp(sc - sc.max())
        out[h] = (w / w.sum()) @ V[:, h // G]
    return out


# --------------------------------------------------------------------------
# dense and window modes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "window"])
def test_dense_and_window_match_jax(mode):
    """append + attend over the paged frame pool; the window plane's ring
    buffer wraps past its 8 slots."""
    NP = 8 if mode == "dense" else 2
    jc, tc = _cfgs(kv_heads=2, head_dim=16, page_tokens=4, num_pages=NP,
                   num_frames=2 * NP, batch=2)
    append = {"dense": (jkv.append_dense, tkv.append_dense),
              "window": (jkv.append_window, tkv.append_window)}[mode]
    attend = {"dense": (jkv.attend_dense, tkv.attend_dense),
              "window": (jkv.attend_window, tkv.attend_window)}[mode]
    rng = np.random.RandomState(3)
    js = jkv.init(jc)
    ts = tkv.init(tc, "cpu")
    assert_same_state(tc, ts, js, "at init")
    lengths = np.zeros((2,), np.int32)
    Ks, Vs = [], []
    for t in range(13):
        kn = rng.randn(2, 2, 16).astype(np.float32)
        vn = rng.randn(2, 2, 16).astype(np.float32)
        Ks.append(kn)
        Vs.append(vn)
        js = append[0](jc, js, jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(lengths))
        append[1](tc, ts, torch.from_numpy(kn), torch.from_numpy(vn),
                  torch.from_numpy(lengths))
        lengths = lengths + 1
        if t % 4 == 3 or t == 12:
            q = rng.randn(2, 4, 16).astype(np.float32)
            jo, js = attend[0](jc, js, jnp.asarray(q), jnp.asarray(lengths))
            to, ts = attend[1](tc, ts, torch.from_numpy(q),
                               torch.from_numpy(lengths))
            assert_close(to, jo, f"{mode} output at t={t}")
            assert_same_state(tc, ts, js, f"({mode}, t={t})")
    if mode == "dense":
        K, V = np.stack(Ks, 1), np.stack(Vs, 1)
        for b in range(2):
            np.testing.assert_allclose(to[b].numpy(),
                                       _naive_attn(q[b], K[b], V[b], 2),
                                       rtol=1e-4, atol=1e-4)
        assert bool(ts.view(tc, "psf").all())


# --------------------------------------------------------------------------
# sparse hybrid mode
# --------------------------------------------------------------------------

SPARSE = dict(kv_heads=2, head_dim=8, page_tokens=4, num_pages=12, batch=2,
              sparse_topk=4, fetch_budget=2, car_threshold=0.5)


@pytest.mark.parametrize("prefetch,qscale,frames,faults", [
    ("none", 0.3, 5, None), ("none", 3.0, 5, None),
    ("sequential", 1.0, 8, None), ("majority", 1.0, 8, None),
    ("none", 1.0, 5, dict(seed=3, fail_prob=0.4))])
def test_attend_sparse_matches_jax(prefetch, qscale, frames, faults):
    """attend_sparse through a frame-churning sweep (with decode lookahead,
    with a fault schedule): the port's batched and reference executors
    against the JAX plane, step by step."""
    jc, tc = _cfgs(num_frames=frames, prefetch=prefetch,
                   prefetch_budget=2 if prefetch != "none" else 0,
                   faults=faults, **SPARSE)
    js = _prefill(jc, 1)
    tb = _to_port(tc, js)
    tr = tb.clone()
    lengths = np.full((2,), jc.num_pages * jc.page_tokens, np.int32)
    lt = torch.from_numpy(lengths)
    step = jax.jit(partial(jkv.attend_sparse, jc, mode="batch"))
    rng = np.random.RandomState(0)
    clean = dataclasses.replace(tc, faults=None)
    dropped = 0
    for i in range(12):
        q = (rng.randn(2, 4, 8) * qscale).astype(np.float32)
        qt = torch.from_numpy(q)
        assert_selection_apart(tc, tb, qt, np.full(2, jc.num_pages))
        if faults:
            probe = tb.clone()
            probe.step = probe.step + 1
            tops = tkv._select(tc, probe, qt,
                               torch.full((2,), 12, dtype=torch.int32),
                               torch.full((2,), 11, dtype=torch.int32))
            p = tkv.plan_fetch(clean, probe, tops)
            dropped += int(((p.page >= 0) & tc.faults.fetch_fail(
                probe.step + 1, p.seq * 12 + p.page.clamp_min(0))).sum())
        jo, js = step(js, jnp.asarray(q), jnp.asarray(lengths))
        ob, tb = tkv.attend_sparse(tc, tb, qt, lt, mode="batch")
        orr, tr = tkv.attend_sparse(tc, tr, qt, lt, mode="reference")
        assert torch.equal(ob, orr), f"executors differ at step {i}"
        assert_close(ob, jo, f"output at step {i}")
        assert_same_state(tc, tb, js, f"(batch, step {i})")
        assert_same_state(tc, tr, js, f"(reference, step {i})")
    assert int((tb.view(tc, "frame_page") >= 0).sum()) > 0
    if faults:
        assert dropped > 0, "the fault schedule dropped no fetch"


def test_sparse_psf_flips_and_packed_fetches():
    """Alternating skewed queries churn a two-frame pool: the magnet pages
    flip PSF to runtime at page-out, record a hot hint, and come back
    packed to their one hot row, in both packages (the scenario of
    tests/test_kvplane_expert.py)."""
    jc, tc = _cfgs(kv_heads=1, head_dim=16, page_tokens=8, num_pages=8,
                   num_frames=2, batch=1, sparse_topk=2, fetch_budget=2,
                   car_threshold=0.8)
    js, ts = _shards(jc, tc, 1)
    rng = np.random.RandomState(3)
    Ks = rng.randn(64, 1, 16).astype(np.float32) * 0.05
    Ks[1 * 8 + 3] = 3.0        # page 1 magnet (for q = +1)
    Ks[4 * 8 + 5] = -3.0       # page 4 magnet (for q = -1)
    Vs = rng.randn(64, 1, 16).astype(np.float32)
    app = jax.jit(partial(jkv.append_sharded, jc))
    for t in range(64):
        lt = np.asarray([t], np.int32)
        js = app(js, jnp.asarray(Ks[t:t + 1]), jnp.asarray(Vs[t:t + 1]),
                 jnp.asarray(lt))
        tkv.append_sharded(tc, ts, torch.from_numpy(Ks[t:t + 1]),
                           torch.from_numpy(Vs[t:t + 1]),
                           torch.from_numpy(lt))
    assert_same_state(tc, ts, js, "after the appends")
    dec = jax.jit(partial(jkv.sharded_sparse_decode, jc))
    lengths = np.asarray([64], np.int32)
    packed = 0
    for i in range(16):
        q = np.full((1, 1, 16), 1.0 if i % 2 == 0 else -1.0, np.float32)
        assert_shards_apart(tc, ts, torch.from_numpy(q), 64)
        jo, js = dec(js, jnp.asarray(q), jnp.asarray(lengths))
        to, ts = tkv.sharded_sparse_decode(tc, ts, torch.from_numpy(q),
                                           torch.from_numpy(lengths))
        assert_close(to, jo, f"step {i}")
        assert_same_state(tc, ts, js, f"(step {i})")
        rows = ts[0].view(tc, "page_rows")
        packed += int(((rows > 0) & (rows < 8)).sum())
    psf = ts[0].view(tc, "psf")[0]
    assert not bool(psf[1]) or not bool(psf[4]), psf
    assert bool(ts[0].view(tc, "hot_hint").any())
    assert packed > 0, "no packed fetch"


@pytest.mark.parametrize("wrap", [False, True])
def test_duplicate_targets_last_write_wins(wrap):
    """With fewer valid pages than K, the -1 selections are sent to page 0
    and frame 0 and write the old CAT row and clock back AFTER the valid
    entry's update, which is lost (JAX applies duplicate writes in order).
    With ``wrap``, page NP-1 is resident, so a -1 selection reads it
    (``page_table[b, -1]``) and attends it as a valid column."""
    jc, tc = _cfgs(kv_heads=1, head_dim=8, page_tokens=4, num_pages=8,
                   num_frames=4, batch=1, sparse_topk=4, fetch_budget=4)
    js = _prefill(jc, 7, magnet=False)
    pt = np.full((1, 8), -1, np.int32)
    fp = np.full((4,), -1, np.int32)
    resident = [(0, 0), (1, 1)] + ([(7, 2)] if wrap else [])
    kf = np.zeros((1, 4, 4, 8), np.float32)
    vf = np.zeros((1, 4, 4, 8), np.float32)
    for pg, f in resident:
        pt[0, pg], fp[f] = f, pg
        kf[:, f] = np.asarray(js.k_slab)[:, pg]
        vf[:, f] = np.asarray(js.v_slab)[:, pg]
    js = js._replace(page_table=jnp.asarray(pt), frame_page=jnp.asarray(fp),
                     k_frames=jnp.asarray(kf), v_frames=jnp.asarray(vf),
                     page_rows=jnp.asarray((pt >= 0).astype(np.int32) * 4))
    ts = _to_port(tc, js)
    lengths = np.asarray([8], np.int32)         # 2 valid pages < K = 4
    q = np.random.RandomState(1).randn(1, 1, 8).astype(np.float32)
    assert_selection_apart(tc, ts, torch.from_numpy(q), [2])
    jo, js2 = jkv.attend_sparse(jc, js, jnp.asarray(q), jnp.asarray(lengths))
    to, ts = tkv.attend_sparse(tc, ts, torch.from_numpy(q),
                               torch.from_numpy(lengths))
    assert_close(to, jo)
    assert_same_state(tc, ts, js2)
    # page 0 was attended and had used rows, yet its CAT row stayed clear
    # the attended columns: frames 0 and 1, then page 7's frame 2 twice
    # (wrap) or nothing
    cols = torch.tensor([[0, 1] + ([2, 2] if wrap else [-1, -1])],
                        dtype=torch.int32)
    rows = torch.where(cols >= 0, 4, 0).to(torch.int32)
    _, used = ref.paged_attention_ref(torch.from_numpy(q),
                                      ts.view(tc, "k_frames"),
                                      ts.view(tc, "v_frames"), cols, rows)
    assert bool(used[0, 0].any())
    cat, clock = ts.view(tc, "cat")[0], ts.view(tc, "clock")
    if wrap:    # the -1 columns are valid (page 7): page 0 keeps its update
        assert torch.equal(cat[0], used[0, 0]) and bool(cat[7].any())
        assert clock.tolist() == [1, 1, 1, 0]
    else:       # ... they write page 0's and frame 0's old values back last
        assert not bool(cat[0].any())
        assert clock.tolist() == [0, 1, 0, 0]


def test_all_faulted_step_gives_zero():
    """Every fetch of the first step faults, so nothing is resident and
    no column is valid: the port gives 0, as the Pallas kernel does in
    interpret mode; the JAX plane's ``ref`` gives NaN.  The states agree."""
    # the first step plans its fetches at tick 2 (step + 1)
    jc, tc = _cfgs(num_frames=5, faults=dict(fail_at=(2,)), **SPARSE)
    js = _prefill(jc, 2)
    ts = _to_port(tc, js)
    lengths = np.full((2,), 48, np.int32)
    q = np.random.RandomState(2).randn(2, 4, 8).astype(np.float32)
    jo, js = jkv.attend_sparse(jc, js, jnp.asarray(q), jnp.asarray(lengths))
    to, ts = tkv.attend_sparse(tc, ts, torch.from_numpy(q),
                               torch.from_numpy(lengths))
    assert bool(jnp.isnan(jo).all())
    assert torch.equal(to, torch.zeros_like(to))
    table = jnp.full((2 * 12,), -1, jnp.int32)
    out_p, used_p = pattn_pallas(jnp.asarray(q).reshape(2, 2, 2, 8),
                                 js.k_frames, js.v_frames, table,
                                 jnp.zeros_like(table), interpret=True)
    np.testing.assert_array_equal(np.asarray(out_p).reshape(2, 4, 8), 0.0)
    assert not bool(np.asarray(used_p).any())
    assert_same_state(tc, ts, js)


# --------------------------------------------------------------------------
# the fetch planner
# --------------------------------------------------------------------------

def test_plan_victims_compact_onto_real_fetches():
    """Victims go to valid fetch entries: seq0's wanted pages are resident
    (pinned), seq1 holds the only misses; the free frame is used and no
    pinned frame is evicted.  The port's plan equals the JAX plan."""
    jc, tc = _cfgs(kv_heads=1, head_dim=4, page_tokens=2, num_pages=8,
                   num_frames=5, batch=2, sparse_topk=2, fetch_budget=2)
    js = jkv.init(jc)
    pt = jnp.full((2, 8), -1, jnp.int32).at[0, :4].set(jnp.arange(4))
    js = js._replace(page_table=pt,
                     frame_page=jnp.asarray([0, 1, 2, 3, -1], jnp.int32),
                     clock=jnp.asarray([5, 6, 7, 8, 0], jnp.int32))
    ts = _to_port(tc, js)
    tops = np.asarray([[0, 1], [4, 5]], np.int32)
    jp = jkv.plan_fetch(jc, js, jnp.asarray(tops))
    tp = tkv.plan_fetch(tc, ts, torch.from_numpy(tops))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    real = tp.victim[tp.page >= 0].tolist()
    assert 4 in real and not set(real) & {0, 1}


@pytest.mark.parametrize("prefetch", ["none", "sequential", "majority"])
def test_plan_fetch_matches_jax(prefetch):
    """plan_fetch on seeded resident sets, clocks and selections (ties in
    the clock included), with and without lookahead."""
    jc, tc = _cfgs(kv_heads=1, head_dim=4, page_tokens=2, num_pages=16,
                   num_frames=12, batch=2, sparse_topk=5, fetch_budget=3,
                   prefetch=prefetch,
                   prefetch_budget=2 if prefetch != "none" else 0)
    rng = np.random.RandomState(11)
    for trial in range(6):
        js = jkv.init(jc)
        gp = rng.choice(32, 9, replace=False)
        frames = rng.choice(12, 9, replace=False)
        pt = np.full((32,), -1, np.int32)
        fp = np.full((12,), -1, np.int32)
        pt[gp], fp[frames] = frames, gp
        js = js._replace(
            page_table=jnp.asarray(pt.reshape(2, 16)),
            frame_page=jnp.asarray(fp),
            psf=jnp.asarray(rng.rand(2, 16) < 0.7),
            clock=jnp.asarray(rng.randint(0, 3, 12).astype(np.int32)))
        ts = _to_port(tc, js)
        tops = np.stack([rng.choice(16, 5, replace=False) for _ in range(2)]
                        ).astype(np.int32)
        tops[1, 3:] = -1
        if trial % 2:
            tops[0] = [2, 4, 6, 8, 10]          # a strided selection
        jp = jkv.plan_fetch(jc, js, jnp.asarray(tops))
        tp = tkv.plan_fetch(tc, ts, torch.from_numpy(tops))
        for name, a, b in zip(tp._fields, tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name}, trial {trial}")


# --------------------------------------------------------------------------
# sharded sparse decode (a loop over shard states on one device)
# --------------------------------------------------------------------------

def _shards(jc, tc, D):
    js = jax.vmap(lambda _: jkv.init(jc))(jnp.arange(D))
    return js, _to_port(tc, js)


def test_sharded_append_attend_matches_jax():
    """append_sharded + sharded_sparse_decode with D=2 shards, both port
    executors against the JAX plane's vmapped oracle."""
    jc, tc = _cfgs(kv_heads=1, head_dim=8, page_tokens=4, num_pages=8,
                   num_frames=3, batch=1, sparse_topk=3, fetch_budget=2,
                   car_threshold=0.5)
    js, tb = _shards(jc, tc, 2)
    tr = [s.clone() for s in tb]
    app = jax.jit(partial(jkv.append_sharded, jc))
    dec = jax.jit(partial(jkv.sharded_sparse_decode, jc, mode="batch"))
    rng = np.random.RandomState(5)
    lengths = np.asarray([0], np.int32)
    for t in range(40):
        kn = rng.randn(1, 1, 8).astype(np.float32)
        vn = rng.randn(1, 1, 8).astype(np.float32)
        js = app(js, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(lengths))
        for st in (tb, tr):
            tkv.append_sharded(tc, st, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(lengths))
        lengths = lengths + 1
        if t % 3 == 2:
            q = rng.randn(1, 1, 8).astype(np.float32)
            assert_shards_apart(tc, tb, torch.from_numpy(q), int(lengths[0]))
            jo, js = dec(js, jnp.asarray(q), jnp.asarray(lengths))
            ob, tb = tkv.sharded_sparse_decode(tc, tb, torch.from_numpy(q),
                                               torch.from_numpy(lengths))
            orr, tr = tkv.sharded_sparse_decode(
                tc, tr, torch.from_numpy(q), torch.from_numpy(lengths),
                mode="reference")
            assert torch.equal(ob, orr)
            assert_close(ob, jo, f"t={t}")
            assert_same_state(tc, tb, js, f"(batch, t={t})")
            assert_same_state(tc, tr, js, f"(reference, t={t})")


def test_sharded_sparse_exact_when_topk_covers():
    """With top-K covering every page, sharded decode is full attention."""
    D, KVH, G, Dh, P, NPs = 2, 2, 2, 16, 4, 8
    jc, tc = _cfgs(kv_heads=KVH, head_dim=Dh, page_tokens=P, num_pages=NPs,
                   num_frames=NPs, batch=1, sparse_topk=NPs,
                   fetch_budget=NPs)
    js, ts = _shards(jc, tc, D)
    rng = np.random.RandomState(3)
    T = 45
    Ks = rng.randn(T, KVH, Dh).astype(np.float32)
    Vs = rng.randn(T, KVH, Dh).astype(np.float32)
    for t in range(T):
        tkv.append_sharded(tc, ts, torch.from_numpy(Ks[t:t + 1]),
                           torch.from_numpy(Vs[t:t + 1]),
                           torch.tensor([t], dtype=torch.int32))
    q = torch.from_numpy(rng.randn(1, KVH * G, Dh).astype(np.float32))
    lengths = torch.tensor([T], dtype=torch.int32)
    tkv.sharded_sparse_decode(tc, ts, q, lengths)       # warm-up fetch
    out, ts = tkv.sharded_sparse_decode(tc, ts, q, lengths)
    np.testing.assert_allclose(out[0].numpy(),
                               _naive_attn(q[0].numpy(), Ks, Vs, G),
                               rtol=1e-4, atol=1e-4)


def test_kv_append_egress_skips_atomically():
    """A faulted append mutates nothing on any shard, as in JAX; the clean
    twin appends."""
    kw = dict(kv_heads=1, head_dim=8, page_tokens=4, num_pages=8,
              num_frames=3, batch=1, sparse_topk=3, fetch_budget=2)
    jf, tf = _cfgs(faults=dict(seed=4, egress_prob=1.0), **kw)
    j0, t0 = _cfgs(**kw)
    js, ts = _shards(j0, t0, 2)
    before = convert.kv_state_to_numpy(t0, ts)
    kn = torch.ones((1, 1, 8))
    lengths = torch.tensor([0], dtype=torch.int32)
    tkv.append_sharded(tf, ts, kn, kn, lengths)
    after = convert.kv_state_to_numpy(tf, ts)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    jout = jkv.append_sharded(jf, js, jnp.ones((1, 1, 8)), jnp.ones((1, 1, 8)),
                              jnp.asarray([0], jnp.int32))
    assert_same_state(tf, ts, jout)
    tkv.append_sharded(t0, ts, kn, kn, lengths)
    assert not np.array_equal(convert.kv_state_to_numpy(t0, ts)["k_slab"],
                              before["k_slab"])


# --------------------------------------------------------------------------
# state conversion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [0, 2])
def test_kv_state_round_trip(shards):
    """JAX state -> port -> numpy gives the JAX fields back, bf16 frames
    and the stacked shard axis included."""
    jc = jkv.KVPlaneConfig(kv_heads=2, head_dim=8, page_tokens=4,
                           num_pages=6, num_frames=3, batch=1, sparse_topk=2,
                           fetch_budget=2)
    tc = tkv.KVPlaneConfig(kv_heads=2, head_dim=8, page_tokens=4,
                           num_pages=6, num_frames=3, batch=1, sparse_topk=2,
                           fetch_budget=2)
    rng = np.random.RandomState(9)
    s = jkv.init(jc)
    s = s._replace(
        k_frames=jnp.asarray(rng.randn(2, 3, 4, 8), jnp.bfloat16),
        page_table=jnp.asarray(rng.randint(-1, 3, (1, 6)), jnp.int32),
        kmax=jnp.asarray(rng.randn(2, 6, 8), jnp.float32),
        cat=jnp.asarray(rng.rand(1, 6, 4) < 0.5),
        clock=jnp.asarray(rng.randint(0, 9, 3), jnp.int32),
        step=jnp.asarray(5, jnp.int32))
    if shards:
        s = jax.tree.map(lambda x: jnp.stack([x] * shards), s)
    ts = _to_port(tc, s)
    assert isinstance(ts, list) == bool(shards)
    assert (ts[0] if shards else ts).k_frames.dtype == torch.bfloat16
    assert_same_state(tc, ts, s)
