"""The port's baseline planes, ``sync`` and ``offload`` against the JAX
package.

Each case builds the same config and seeded numpy data in both packages
and drives the paging plane (Fastswap analogue) or the object plane (AIFM
analogue, with its object-level LRU reclaim) through the same batches.
After every step the whole plane state must agree: every int, bool and
row field and every counter bit for bit, ``car_ema``/``car_thr`` too (the
JAX plane runs ``kernel_impl="ref"``), and so must the served rows.  The
port's batch executor is also held to its own reference executor.  The
reclaim cases build ties in ``obj_last``, scan windows
(``lru_scan_budget``) and a target no eviction can reach.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import faults as jfaults
from repro.core import offload as joffload
from repro.core import state as jstate
from repro.core import sync as jsync
from repro.core.layout import PlaneConfig as JConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import faults as tfaults
from repro_torch.core import offload as toffload
from repro_torch.core import state as tstate
from repro_torch.core import sync as tsync
from repro_torch.core.layout import PlaneConfig
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine, EngineConfig

N_OBJS, DIM = 96, 4
FAULTS = dict(seed=5, fail_prob=0.25, egress_prob=0.25)


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
def jitted(jc: JConfig, plane: str, degraded: bool = False):
    fn = jbase.paging_access if plane == "paging" else jbase.object_access
    return jax.jit(functools.partial(fn, jc, degraded=degraded))


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


def assert_port_states_equal(a, b, ctx=""):
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for k in x:
        if k == "stats":
            for kk in x[k]:
                np.testing.assert_array_equal(x[k][kk], y[k][kk],
                                              err_msg=f"stats.{kk} {ctx}")
        else:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{k} {ctx}")


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
        if step % 5 == 4:
            ids[-3:] = -1                         # padded no-op requests
        yield step, ids


def drive(plane, jc, tc, data, kind, steps, *, degraded_every=0):
    """Both packages through the same batches, compared after every step;
    the port's batch executor also against its reference executor.  Every
    ``degraded_every``-th step plans degraded (local hits only)."""
    js = jstate.create(jc, jnp.asarray(data))
    ts = tstate.create(tc, torch.from_numpy(data), device="cpu")
    tr = ts.clone()
    fn = tbase.paging_access if plane == "paging" else tbase.object_access
    for step, ids in traffic(kind, steps, tc.num_objs):
        deg = bool(degraded_every) and step % degraded_every == 1
        js, jrows = jitted(jc, plane, deg)(js, jnp.asarray(ids))
        ids_t = torch.from_numpy(ids)
        _, rows = fn(tc, ts, ids_t, degraded=deg)
        _, rrows = fn(tc, tr, ids_t, degraded=deg, mode="reference")
        np.testing.assert_array_equal(np.asarray(jrows), rows.numpy(),
                                      err_msg=f"rows, step {step}")
        np.testing.assert_array_equal(rrows.numpy(), rows.numpy(),
                                      err_msg=f"reference rows, step {step}")
        assert_same_state(js, ts, f"({plane}, {kind}, step {step})")
        assert_port_states_equal(ts, tr, f"batch vs reference, step {step}")
    return ts


@pytest.mark.parametrize("kind", ["random", "zipf", "sequential"])
@pytest.mark.parametrize("plane", ["paging", "object"])
def test_baseline_matches_jax(plane, kind):
    jc, tc, data = make()
    ts = drive(plane, jc, tc, data, kind, 14)
    st = {k: int(v) for k, v in ts.stats._asdict().items()}
    assert st["misses"] > 0
    if plane == "paging":
        assert st["page_ins"] > 0 and st["obj_ins"] == 0
        assert st["page_outs"] > 0 and st["lru_scans"] == 0
    else:
        assert st["obj_ins"] > 0 and st["page_ins"] == 0
        assert st["obj_outs"] > 0 and st["lru_scans"] > 0


def test_paging_majority_prefetch_matches_jax():
    jc, tc, data = make(prefetch="majority")
    ts = drive("paging", jc, tc, data, "sequential", 12)
    assert int(ts.stats.prefetch_issued) > 0


@pytest.mark.parametrize("plane", ["paging", "object"])
def test_baseline_faults_and_degraded_match_jax(plane):
    """Fetch and egress faults masked at plan time, and degraded plans
    (the engine's open breaker) every third step."""
    jc, tc, data = make(faults=True)
    ts = drive(plane, jc, tc, data, "random", 15, degraded_every=3)
    assert int(ts.stats.fetch_failures) > 0


@pytest.mark.parametrize("budget", [0, 7, 32, 96])
def test_reclaim_under_pressure_matches_jax(budget):
    """The object plane at 4 of 12 frames free after every batch, with the
    LRU over a full scan (0, and a budget of num_objs) or a rotating
    window (7 does not divide num_objs)."""
    jc, tc, data = make(num_frames=12, lru_scan_budget=budget)
    ts = drive("object", jc, tc, data, "random", 12)
    assert int(ts.stats.obj_outs) > 20
    want_scans = budget if 0 < budget < N_OBJS else N_OBJS
    assert int(ts.stats.lru_scans) % want_scans == 0


def tied_state(jc, data):
    """A JAX object-plane state whose local objects share ``obj_last``
    stamps (each came in with a batch of 16 at one step): the LRU's first
    minimum decides among them."""
    s = jstate.create(jc, jnp.asarray(data))
    f = jax.jit(functools.partial(jbase.object_access, jc,
                                  reclaim_free_target=0))
    rng = np.random.RandomState(3)
    for _ in range(5):
        s, _ = f(s, jnp.asarray(rng.permutation(jc.num_objs)[:16]
                                .astype(np.int32)))
    last = np.asarray(s.obj_last)
    assert np.bincount(last).max() >= 16            # ties
    return s


@pytest.mark.parametrize("target", [8, 10, 40])
@pytest.mark.parametrize("budget", [0, 5])
def test_reclaim_ties_and_unreachable_target(budget, target):
    """``object_reclaim`` alone from a state full of ``obj_last`` ties,
    to a reachable target and to one no eviction reaches (40 of 12 frames:
    every evictable object goes, then the remaining rounds only scan)."""
    jc, tc, data = make(num_frames=12, lru_scan_budget=budget)
    js = tied_state(jc, data)
    ts = convert.state_from_numpy(tc, jax.device_get(js), device="cpu")
    js = jax.jit(functools.partial(jbase.object_reclaim, jc),
                 static_argnums=1)(js, target)
    rec = tbase.ObjectReclaim()
    rec(tc, ts, target)
    assert_same_state(js, ts, f"reclaim to {target}")
    assert int(ts.stats.obj_outs) > 0
    if target == 40:
        # the loop stopped reading once nothing was evictable
        assert rec.reads <= rec.rounds + 1 < 12
        assert rec.rounds < N_OBJS // tc.object_evict_batch + 2


def test_reclaim_bound_skips_reads_and_changes_nothing():
    """One ``ObjectReclaim`` kept across batches reads the device less
    often than a fresh ``object_reclaim`` per batch, with the same state."""
    _, tc, data = make(num_frames=12)
    a = tstate.create(tc, torch.from_numpy(data), device="cpu")
    b = a.clone()
    rec = tbase.ObjectReclaim()
    calls = 0
    for _, ids in traffic("random", 20, N_OBJS, seed=4):
        ids_t = torch.from_numpy(ids)
        tbase.object_access(tc, a, ids_t, reclaim=rec)
        tbase.object_access(tc, b, ids_t)
        calls += 1
    assert_port_states_equal(a, b, "kept vs fresh reclaim")
    assert int(a.stats.obj_outs) > 0
    assert 0 < rec.reads < calls + rec.rounds


def test_object_engine_ignores_reclaim_free_target_as_jax_does():
    """The JAX engine binds the object plane's access without
    ``reclaim_free_target``, so it always reclaims to 2 free frames; the
    port's engine must do the same at any other value of the field."""
    jc, tc, data = make(num_frames=12)
    ekw = dict(plane="object", batch=16, dispatch="sync",
               reclaim_free_target=4)
    je = JEngine(JEngineConfig(**ekw), jc, jnp.asarray(data))
    te = Engine(EngineConfig(**ekw), tc, data, device="cpu")
    for step, ids in traffic("random", 16, N_OBJS, seed=6):
        rows = te.serve_batch(ids).numpy()
        np.testing.assert_array_equal(rows, np.asarray(je.serve_batch(ids)),
                                      err_msg=f"rows, step {step}")
        assert_same_state(je.state, te.state, f"step {step}")
    assert te.counters == je.counters
    assert int(te.state.stats.obj_outs) > 0 and int(te.state.stats.lru_scans) > 0


def test_sync_matches_jax():
    """pin/unpin with duplicate ids accumulate; the live-lock guard flips
    pinned local pages to paging under pressure."""
    jc, tc, data = make()
    js = jstate.create(jc, jnp.asarray(data))
    f = jax.jit(functools.partial(jbase.object_access, jc))
    for _, ids in traffic("random", 4, N_OBJS, seed=6):
        js, _ = f(js, jnp.asarray(ids))
    ts = convert.state_from_numpy(tc, jax.device_get(js), device="cpu")
    local = np.nonzero(np.asarray(js.backing)[
        np.asarray(js.obj_loc) // 8] == 1)[0]
    ids = np.concatenate([local[:5], local[:3], local[:1],
                          [0, 0, 95]]).astype(np.int32)   # duplicates
    js = jsync.pin_objects(jc, js, jnp.asarray(ids))
    tsync.pin_objects(tc, ts, torch.from_numpy(ids))
    assert_same_state(js, ts, "pin")
    assert int(ts.pin.max()) >= 3
    for thr in (0.9, 0.0):
        np.testing.assert_array_equal(
            np.asarray(jsync.pinned_fraction(jc, js)),
            tsync.pinned_fraction(tc, ts).numpy())
        js = jsync.force_paging_under_pressure(jc, js, thr)
        tsync.force_paging_under_pressure(tc, ts, thr)
        assert_same_state(js, ts, f"force_paging {thr}")
    js = jsync.unpin_objects(jc, js, jnp.asarray(ids))
    tsync.unpin_objects(tc, ts, torch.from_numpy(ids))
    assert_same_state(js, ts, "unpin")


def test_offload_matches_jax():
    """remote_apply reads each page from its one tier (local pages from
    frames, remote ones from the slab), maps fn over the pages and pins
    them, duplicates included; remote_release unpins."""
    jc, tc, data = make()
    js = jstate.create(jc, jnp.asarray(data))
    f = jax.jit(functools.partial(jbase.paging_access, jc))
    for _, ids in traffic("random", 3, N_OBJS, seed=8):
        js, _ = f(js, jnp.asarray(ids))
    ts = convert.state_from_numpy(tc, jax.device_get(js), device="cpu")
    backing = np.asarray(js.backing)
    vp = np.concatenate([np.nonzero(backing == 1)[0][:3],
                         np.nonzero(backing == 2)[0][:3]])
    vp = np.concatenate([vp, vp[:2]]).astype(np.int32)    # duplicates
    assert (backing[vp] == 1).any() and (backing[vp] == 2).any()
    js, jres = joffload.remote_apply(
        jc, js, jnp.asarray(vp), lambda p: jnp.sum(p * p, axis=0))
    ts, tres = toffload.remote_apply(
        tc, ts, torch.from_numpy(vp), lambda p: (p * p).sum(dim=0))
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    assert_same_state(js, ts, "remote_apply")
    want = np.stack([convert.state_to_numpy(ts)["slab"][v]
                     if backing[v] == 2 else
                     convert.state_to_numpy(ts)["frames"][
                         np.asarray(js.frame_of)[v]] for v in vp])
    np.testing.assert_array_equal(tres.numpy(), (want * want).sum(axis=1))
    js = joffload.remote_release(jc, js, jnp.asarray(vp))
    toffload.remote_release(tc, ts, torch.from_numpy(vp))
    assert_same_state(js, ts, "remote_release")


@pytest.mark.parametrize("plane", ["paging", "object"])
def test_launcher_serves_baseline_on_cpu(plane, capsys):
    serve.main(["--plane", plane, "--objects", "512", "--steps", "4",
                "--batch", "16", "--device", "cpu"])
    assert f"plane={plane}" in capsys.readouterr().out
