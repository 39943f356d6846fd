"""The port's hybrid plane against the JAX plane, step by step.

Each case builds the same config and the same data in both packages and
drives both through the same interleaving of ``access``, ``update``,
``evacuate`` and ``advance_epoch`` (random, skewed and sequential traffic,
both prefetch planners, with and without a fault schedule, with padded
``-1`` ids).  After every step the whole plane state must agree: every
int, bool and row field and every counter bit for bit, ``car_ema`` and
``car_thr`` too (the JAX plane runs ``kernel_impl="ref"``, whose CAR EMA
rounds exactly as the port's; see test_torch_kernels), and so must the
served rows.  The JAX side is the reference; the cases at the end are
built to hit each place where JAX and PyTorch differ.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import batch as jbatch
from repro.core import faults as jfaults
from repro.core import plane as jplane
from repro.core import state as jstate
from repro.core.layout import PlaneConfig as JConfig
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core import faults as tfaults
from repro_torch.core import plane as tplane
from repro_torch.core import state as tstate
from repro_torch.core.layout import PlaneConfig

N_OBJS, DIM = 96, 4
FAULTS = dict(seed=3, fail_prob=0.2, egress_prob=0.2)


def make(faults=False, **kw):
    """(JAX config, port config, data) for one small plane."""
    kw = dict(dict(num_objs=N_OBJS, obj_dim=DIM, page_objs=8, num_frames=6,
                   num_vpages=40, readahead=2, prefetch_budget=4), **kw)
    jc = JConfig(kernel_impl="ref",
                 faults=jfaults.Schedule(**FAULTS) if faults else None, **kw)
    tc = PlaneConfig(faults=tfaults.Schedule(**FAULTS) if faults else None,
                     **kw)
    data = np.random.RandomState(0).randn(kw["num_objs"], kw["obj_dim"]
                                          ).astype(np.float32)
    return jc, tc, data


@functools.lru_cache(maxsize=None)
def jitted(jc: JConfig):
    """The JAX plane's entry points for one config (compiled once)."""
    return dict(
        access=jax.jit(functools.partial(jplane.access, jc)),
        update=jax.jit(functools.partial(jplane.update, jc)),
        evacuate=jax.jit(functools.partial(jplane.evacuate, jc,
                                           garbage_threshold=-1.0,
                                           max_pages=4)),
        epoch=jax.jit(functools.partial(jplane.advance_epoch, jc)),
        plan=jax.jit(functools.partial(jbatch.plan_access, jc)))


def assert_same_state(js, ts, ctx=""):
    a = jax.device_get(js)._asdict()
    b = convert.state_to_numpy(ts)
    for k, x in a.items():
        if k == "stats":
            for kk, vv in x._asdict().items():
                np.testing.assert_array_equal(
                    np.asarray(vv), b[k][kk], err_msg=f"stats.{kk} {ctx}")
            continue
        x = np.asarray(x)
        assert x.dtype == b[k].dtype, (k, ctx)
        np.testing.assert_array_equal(x, b[k], err_msg=f"{k} diverged {ctx}")


def traffic(kind: str, steps: int, n_objs: int, seed: int = 1):
    rng = np.random.RandomState(seed)
    for step in range(steps):
        if kind == "random":
            ids = rng.randint(0, n_objs, 16)
        elif kind == "zipf":
            ids = np.clip(rng.zipf(1.5, 16) - 1, 0, n_objs - 1)
        else:
            ids = (np.arange(16) + step * 16) % n_objs
        ids = ids.astype(np.int32)
        if step % 7 == 6:
            ids[-3:] = -1                         # padded no-op requests
        yield step, ids, rng.randn(16, DIM).astype(np.float32)


def drive(jc, tc, data, kind, steps, *, oracle=False):
    """Run both planes through the same interleaving, comparing after every
    step; with ``oracle`` also run the port's scalar reference executor
    and hold the batched one to it."""
    f = jitted(jc)
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    tr = ts.clone() if oracle else None
    for step, ids, rows in traffic(kind, steps, tc.num_objs):
        ids_t, rows_t = torch.from_numpy(ids), torch.from_numpy(rows)
        op = step % 5
        if op < 3:
            js, jrows = f["access"](js, jnp.asarray(ids))
            ts, trows = tplane.access(tc, ts, ids_t)
            np.testing.assert_array_equal(np.asarray(jrows), trows.numpy(),
                                          err_msg=f"rows, step {step}")
            if oracle:
                tr, rrows = tplane.access(tc, tr, ids_t, mode="reference")
                np.testing.assert_array_equal(rrows.numpy(), trows.numpy())
        elif op == 3:
            js = f["update"](js, jnp.asarray(ids), jnp.asarray(rows))
            tplane.update(tc, ts, ids_t, rows_t)
            if oracle:
                tplane.update(tc, tr, ids_t, rows_t, mode="reference")
        else:
            js = f["epoch"](f["evacuate"](js))
            tplane.evacuate(tc, ts, garbage_threshold=-1.0, max_pages=4)
            tplane.advance_epoch(tc, ts)
            if oracle:
                tplane.evacuate(tc, tr, garbage_threshold=-1.0, max_pages=4)
                tplane.advance_epoch(tc, tr)
        assert_same_state(js, ts, f"({kind}, step {step})")
        if oracle:
            a, b = convert.state_to_numpy(ts), convert.state_to_numpy(tr)
            for k in a:
                if k != "stats":
                    np.testing.assert_array_equal(
                        a[k], b[k], err_msg=f"batch vs reference: {k}, "
                                            f"step {step}")
    return js, ts


@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("prefetch", ["sequential", "majority"])
@pytest.mark.parametrize("kind", ["random", "zipf", "sequential"])
def test_plane_matches_jax(kind, prefetch, faults):
    jc, tc, data = make(faults, prefetch=prefetch)
    js, ts = drive(jc, tc, data, kind, 25)
    stats = {k: int(v) for k, v in ts.stats._asdict().items()}
    assert stats["misses"] > 0 and stats["evac_pages"] > 0
    assert stats["epochs"] == 5
    assert (stats["fetch_failures"] > 0) == faults
    assert all(tplane.check_invariants(tc, ts).values())
    assert tplane.check_invariants(tc, ts) == jplane.check_invariants(jc, js)


def test_plane_matches_jax_runtime_birth():
    """Pages born on the runtime path, a partial last data page and a tight
    frame pool (fresh-page allocation evicts on every batch)."""
    jc, tc, data = make(psf_init_paging=False, car_threshold=0.6,
                        num_objs=90, num_frames=5, page_objs=4,
                        num_vpages=70)
    _, ts = drive(jc, tc, data, "random", 20)
    assert int(ts.stats.obj_ins) > 0 and int(ts.stats.page_outs) > 0


@pytest.mark.parametrize("kind,faults", [("random", False), ("zipf", True),
                                         ("sequential", False)])
def test_batch_matches_reference_executor(kind, faults):
    """The port's own oracle: the scalar executor replays the identical
    plan one update at a time and must agree bit for bit (and both agree
    with the JAX plane)."""
    jc, tc, data = make(faults, prefetch="majority")
    drive(jc, tc, data, kind, 15, oracle=True)


# --------------------------------------------------------------------------
# cases built for the places where JAX and PyTorch differ
# --------------------------------------------------------------------------

def teststable_order_matches_lax_top_k():
    """Ties go to the lowest index, ascending and descending, as in
    ``lax.top_k``; ``torch.topk`` does not promise that order."""
    rng = np.random.RandomState(5)
    for _ in range(20):
        x = rng.randint(0, 4, size=64).astype(np.int32)
        _, asc = tbatch.stable_order(torch.from_numpy(x))
        _, want = lax.top_k(-jnp.asarray(x), 64)
        np.testing.assert_array_equal(asc.numpy(), np.asarray(want))
        xf = (x / 3.0).astype(np.float32)
        _, desc = tbatch.stable_order(torch.from_numpy(xf), descending=True)
        _, want = lax.top_k(jnp.asarray(xf), 64)
        np.testing.assert_array_equal(desc.numpy(), np.asarray(want))


def _plans_equal(jp, tp):
    for name, x in jp._asdict().items():
        np.testing.assert_array_equal(np.asarray(x),
                                      getattr(tp, name).numpy(),
                                      err_msg=f"AccessPlan.{name}")


def test_victim_ties_all_frames_free():
    """On a fresh plane every frame is free: all victim scores tie at
    -INF32, and the planned frames must be JAX's (lowest index first).
    Then equal clocks tie among occupied frames."""
    jc, tc, data = make(num_frames=8)
    f = jitted(jc)
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    ids = (np.arange(16) * 6 % N_OBJS).astype(np.int32)   # 12 pages
    tp = tbatch.plan_access(tc, ts, torch.from_numpy(ids))
    _plans_equal(f["plan"](js, jnp.asarray(ids)), tp)
    vic = tp.pg_victim.numpy()
    assert list(vic[vic >= 0][:8]) == list(range(8))
    for step in range(4):                     # every frame touched at once
        js, _ = f["access"](js, jnp.asarray(ids))
        ts, _ = tplane.access(tc, ts, torch.from_numpy(ids))
        other = ((ids + 3 + step) % N_OBJS).astype(np.int32)
        _plans_equal(f["plan"](js, jnp.asarray(other)),
                     tbatch.plan_access(tc, ts, torch.from_numpy(other)))
        js, _ = f["access"](js, jnp.asarray(other))
        ts, _ = tplane.access(tc, ts, torch.from_numpy(other))
        assert_same_state(js, ts, f"tie step {step}")


def test_evacuation_victim_ties_equal_garbage_ratios():
    """Several local pages with the same dead-slot ratio: the evacuator must
    pick them in JAX's order (lowest vpage first among equals)."""
    jc, tc, data = make(num_frames=12)
    js = jstate.create(jc, jnp.asarray(data))
    d = jax.device_get(js)._asdict()
    backing, alloc, live = (np.array(d["backing"]), np.array(d["alloc_count"]),
                            np.array(d["live_count"]))
    pages = [9, 2, 7, 4, 11, 0]
    backing[pages] = 1                          # LOCAL
    alloc[pages] = 8
    live[pages] = [4, 4, 2, 4, 2, 6]            # ratios .5 .5 .75 .5 .75 .25
    d.update(backing=backing, alloc_count=alloc, live_count=live)
    js = js._replace(**{k: jnp.asarray(d[k])
                        for k in ("backing", "alloc_count", "live_count")})
    ts = convert.state_from_numpy(tc, jax.device_get(js), device="cpu")
    for k in (3, 6):
        jp = jplane.plan_evacuate(jc, js, 0.1, max_pages=k)
        tp = tplane.plan_evacuate(tc, ts, 0.1, max_pages=k)
        np.testing.assert_array_equal(np.asarray(jp.victims),
                                      tp.victims.numpy())
        np.testing.assert_array_equal(np.asarray(jp.ok), tp.ok.numpy())
    assert list(tp.victims.numpy()) == [7, 11, 2, 4, 9, 0]


def test_padded_ids_scatter_nowhere():
    """Padded ``-1`` ids are sentinel scatters that JAX drops; the port
    sends them to its trash rows.  An all-padded batch changes nothing but
    the step, and a mixed one serves zero rows for the padding."""
    jc, tc, data = make()
    f = jitted(jc)
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    for ids in (np.full(16, -1, np.int32),
                np.array([5, -1, 5, 40, -1, -1, 95, 0] * 2, np.int32)):
        js, jrows = f["access"](js, jnp.asarray(ids))
        ts, trows = tplane.access(tc, ts, torch.from_numpy(ids))
        np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())
        assert not trows[torch.from_numpy(ids) < 0].any()
        assert_same_state(js, ts, f"padded {ids}")
        rows = np.random.RandomState(2).randn(16, DIM).astype(np.float32)
        js = f["update"](js, jnp.asarray(ids), jnp.asarray(rows))
        tplane.update(tc, ts, torch.from_numpy(ids), torch.from_numpy(rows))
        assert_same_state(js, ts, f"padded update {ids}")


def test_update_last_write_wins_and_reads_back():
    """Duplicate ids in one update: the last write wins, in both tiers, and
    a later read (also after writeback and eviction) returns it."""
    jc, tc, data = make(num_frames=8)
    f = jitted(jc)
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    ids = np.array([3, 50, 3, 77, 50, 3, 10, 90] * 2, np.int32)
    rows = np.random.RandomState(4).randn(16, DIM).astype(np.float32)
    truth = data.copy()
    truth[ids] = rows                            # numpy: last write wins
    js = f["update"](js, jnp.asarray(ids), jnp.asarray(rows))
    tplane.update(tc, ts, torch.from_numpy(ids), torch.from_numpy(rows))
    assert_same_state(js, ts, "update")
    all_ids = torch.arange(N_OBJS, dtype=torch.int32)
    np.testing.assert_array_equal(tplane.peek(tc, ts, all_ids).numpy(), truth)
    js = jplane.evict_all(jc, jplane.writeback_all(jc, js))
    tplane.evict_all(tc, tplane.writeback_all(tc, ts))
    assert_same_state(js, ts, "writeback + evict")
    assert not (ts.backing[:tc.num_vpages] == 1).any()   # nothing LOCAL
    assert float(tplane.occupancy(tc, ts)) == float(jplane.occupancy(jc, js))
    _, got = tplane.access(tc, ts, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), truth[ids])


def test_append_obj_matches_jax():
    """The scalar append helper (``paths._append_obj``: fill-cursor
    retirement, fresh log page, smart-pointer rewrite, GC of the old copy)
    against the JAX helper, object by object, with frame eviction."""
    from repro.core import paths as jpaths
    from repro_torch.core import paths as tpaths
    jc, tc, data = make(num_frames=4)
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    append = jax.jit(lambda s, o, row: jpaths._append_obj(
        jc, s, o, row, "fill_vpage")[0])
    rng = np.random.RandomState(6)
    for o in list(range(8)) + list(rng.randint(0, N_OBJS, 30)):
        row = rng.randn(DIM).astype(np.float32)
        js = append(js, jnp.int32(o), jnp.asarray(row))
        tpaths._append_obj(tc, ts, torch.tensor(o, dtype=torch.int32),
                           torch.from_numpy(row), "fill_vpage")
        assert_same_state(js, ts, f"append {o}")
    assert int(ts.stats.page_outs) > 0


@functools.lru_cache(maxsize=None)
def _mid_faulted_run():
    """Both planes 8 steps into a faulted zipf run (``plan_access`` only
    reads the state, so the knob cases share it)."""
    jc, tc, data = make(True, prefetch="majority")
    js, ts = drive(jc, tc, data, "zipf", 8)
    return jc, tc, js, ts


@pytest.mark.parametrize("knobs", [
    dict(split_by_psf=False),                 # the paging baseline's plan
    dict(all_runtime=True),                   # the object baseline's plan
    dict(degraded=True),                      # circuit-breaker mode
    dict(degraded="traced"),                  # per-shard breaker flag
    dict(for_update=True, shard=1),           # write path, egress faults
], ids=["paging", "object", "degraded", "degraded-traced", "update"])
def test_plan_access_knobs_match_jax(knobs):
    """Every knob of ``plan_access`` (the baselines, the breaker modes and
    the write path under an egress-fault schedule) plans as JAX does, on a
    plane mid-way through a faulted run."""
    jc, tc, js, ts = _mid_faulted_run()
    ids = np.array([3, 17, -1, 60, 3, 88, 41, 5, 9, 70, 2, 33, 95, 12, 50,
                    66], np.int32)
    jk, tk = dict(knobs), dict(knobs)
    if knobs.get("degraded") == "traced":
        jk["degraded"], tk["degraded"] = jnp.asarray(True), torch.tensor(True)
    jp = jbatch.plan_access(jc, js, jnp.asarray(ids), **jk)
    _plans_equal(jp, tbatch.plan_access(tc, ts, torch.from_numpy(ids), **tk))


def test_advance_epoch_with_traffic_override_matches_jax():
    """The governor's ``traffic`` override (the sharded plane passes the
    global byte totals there) moves the threshold as in JAX."""
    jc, tc, data = make()
    js, ts = drive(jc, tc, data, "random", 6)
    for d_page, d_obj in [(4096.0, 128.0), (0.0, 0.0), (256.0, 8192.0)]:
        js = jplane.advance_epoch(jc, js, traffic=(jnp.float32(d_page),
                                                   jnp.float32(d_obj)))
        tplane.advance_epoch(tc, ts, traffic=(torch.tensor(d_page),
                                              torch.tensor(d_obj)))
        assert_same_state(js, ts, f"traffic {d_page}, {d_obj}")
