"""The port's robust serving engine against the JAX engine.

Both engines run ``dispatch="sync"`` on the same seeded data, the same
fault schedule and the same batches (the engine cases of
tests/test_faults.py): every returned row, every chaos counter (served,
retries, sheds, deadline misses, degraded ticks, breaker trips) and the
whole final plane state must agree bit for bit, on all three planes.
Wall-clock deadlines are set far from the tick time (a 1 ms deadline
against an arrival 1 s late, or 1e9 us), so no outcome depends on the
machine.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core.layout import PlaneConfig as JConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.core import faults as tfaults
from repro_torch.core import plane as tplane
from repro_torch.core.layout import PlaneConfig
from repro_torch.serving.engine import Engine, EngineConfig

N_OBJS, BATCH = 256, 16
PLANE = dict(num_objs=N_OBJS, obj_dim=8, page_objs=8, num_frames=12,
             num_vpages=3 * (N_OBJS // 8))
DATA = np.random.RandomState(0).rand(N_OBJS, 8).astype(np.float32)
PLANES = ["hybrid", "paging", "object"]


def engines(plane="hybrid", sched=None, dispatch="sync", **ekw):
    """(JAX engine, port engine) on the same plane, data and schedule
    (``sched``: the ``Schedule`` keyword arguments, or "null")."""
    js = ts = None
    if sched == "null":
        js, ts = jfaults.NULL, tfaults.NULL
    elif sched is not None:
        js, ts = jfaults.Schedule(**sched), tfaults.Schedule(**sched)
    je = JEngine(JEngineConfig(plane=plane, batch=BATCH, dispatch="sync",
                               faults=js, **ekw),
                 JConfig(kernel_impl="ref", **PLANE), jnp.asarray(DATA))
    te = Engine(EngineConfig(plane=plane, batch=BATCH, dispatch=dispatch,
                             faults=ts, **ekw),
                PlaneConfig(**PLANE), DATA, device="cpu")
    return je, te


def assert_same_state(js, ts, ctx=""):
    a = jax.device_get(js)._asdict()
    b = convert.state_to_numpy(ts)
    for k, x in a.items():
        if k == "stats":
            for kk, vv in x._asdict().items():
                np.testing.assert_array_equal(
                    np.asarray(vv), b[k][kk], err_msg=f"stats.{kk} {ctx}")
        else:
            np.testing.assert_array_equal(np.asarray(x), b[k],
                                          err_msg=f"{k} {ctx}")


def batches(n, size=BATCH, seed0=0):
    return [np.random.RandomState(seed0 + s).randint(0, N_OBJS, size=size
                                                     ).astype(np.int32)
            for s in range(n)]


def serve_both(je, te, ids, **kw):
    """One tick through both engines; the returned rows agree."""
    jr = je.submit(ids, **kw)
    je.drain()
    tr = te.submit(ids, **kw)
    te.drain()
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    return tr.numpy()


@pytest.mark.parametrize("plane", PLANES)
def test_fault_free_robust_bit_identical(plane):
    """Every robust knob armed with a null schedule: the same rows, state
    and counters as the plain port engine and as the JAX robust engine."""
    kw = dict(max_retries=3, deadline_us=1e9, breaker_threshold=0.5)
    je, te = engines(plane, "null", **kw)
    plain = Engine(EngineConfig(plane=plane, batch=BATCH, dispatch="sync"),
                   PlaneConfig(**PLANE), DATA, device="cpu")
    for ids in batches(10):
        rows = serve_both(je, te, ids)
        np.testing.assert_array_equal(rows, plain.serve_batch(ids).numpy())
        np.testing.assert_array_equal(rows, DATA[ids])
    assert_same_state(je.state, te.state, plane)
    assert_same_state(je.state, plain.state, f"plain {plane}")
    assert te.counters == je.counters
    c = te.counters
    assert c["fetch_retries"] == 0 and c["shed_requests"] == 0
    assert c["degraded_ticks"] == 0 and not te.breaker_open
    assert c["served"] == 160


@pytest.mark.parametrize("plane", PLANES)
def test_retries_recover_goodput(plane):
    """20% of remote fetches fail; retries ride in the batch tail and
    recover nearly everything.  Counters, stats and state as JAX's."""
    je, te = engines(plane, dict(seed=7, fail_prob=0.2), max_retries=6)
    wl = batches(30, size=BATCH - 4)
    jrep, trep = je.run(wl), te.run(wl)
    assert trep["counters"] == jrep["counters"]
    assert trep["stats"] == {k: int(v) for k, v in
                             jax.device_get(je.state.stats)._asdict().items()}
    assert_same_state(je.state, te.state, plane)
    c = trep["counters"]
    assert c["fetch_retries"] > 0
    assert c["served"] + c["shed_requests"] == 30 * (BATCH - 4)
    assert c["served"] >= int(0.99 * 30 * (BATCH - 4))
    assert trep["stats"]["fetch_failures"] > 0
    assert trep["goodput_rps"] <= trep["throughput_rps"]
    assert trep["latency"]["n"] == c["served"]
    assert all(tplane.check_invariants(te.pcfg, te.state).values())


@pytest.mark.parametrize("plane", PLANES)
def test_retry_serves_correct_value(plane):
    """Tick 2 (the warm-up is tick 1) faults every fetch: the whole batch
    is queued, the flush serves it, and the rows read back true."""
    je, te = engines(plane, dict(seed=2, fail_at=(2,)), max_retries=2)
    ids = np.arange(16, 32, dtype=np.int32)   # pages the warm-up never touched
    rows = serve_both(je, te, ids)
    assert not rows.any()                     # nothing served this tick
    assert len(te._retryq) == len(je._retryq) == 16
    je.flush_retries()
    te.flush_retries()
    assert not te._retryq and te.counters["served"] == 16
    assert te.counters == je.counters
    np.testing.assert_array_equal(serve_both(je, te, ids), DATA[ids])
    assert_same_state(je.state, te.state, plane)


def test_deadline_shed_at_admission():
    """An arrival 1 s past a 1 ms deadline is shed whole at admission; so
    are queued retries past it; on-time arrivals are served."""
    je, te = engines("hybrid", dict(seed=2, fail_at=(3,)),
                     deadline_us=1000.0, max_retries=1)
    ids = np.arange(16, dtype=np.int32)
    rows = serve_both(je, te, ids, t_sched=time.time() - 1.0)
    assert rows.shape == (16, 8) and not rows.any()
    assert te.counters["shed_requests"] == 16
    assert te.counters["deadline_misses"] >= 16
    assert te.counters["served"] == 0
    fresh = np.arange(64, 80, dtype=np.int32)
    serve_both(je, te, fresh)                 # tick 3 faults: all queued
    assert len(te._retryq) == 16
    time.sleep(0.01)                          # the queued retries go stale
    serve_both(je, te, np.arange(8, dtype=np.int32))
    c = te.counters
    assert c["shed_requests"] == 32 and c["served"] == 8
    for k in ("served", "fetch_retries", "shed_requests", "degraded_ticks"):
        assert c[k] == je.counters[k], k
    assert_same_state(je.state, te.state)


@pytest.mark.parametrize("scope", ["shard", "global"])
def test_breaker_degrades_and_recovers(scope):
    """A total outage over device ticks 10-39: the breaker trips, degraded
    ticks serve local hits only, probes find the far tier back and the
    breaker closes; a same-schedule replay gives identical counters."""
    kw = dict(max_retries=1, breaker_threshold=0.5, breaker_probe_every=4,
              breaker_scope=scope)
    sched = dict(seed=7, outages=((10, 40, -1),))

    def drive(pair):
        je, te = pair
        tripped = False
        for ids in batches(60):
            serve_both(je, te, ids)
            tripped |= te.breaker_open
            assert te.breaker_open == je.breaker_open
        je.flush_retries()
        te.flush_retries()
        return je, te, tripped

    je, te, tripped = drive(engines("hybrid", sched, **kw))
    assert tripped, "breaker never opened during the outage"
    assert not te.breaker_open, "breaker failed to close after recovery"
    assert te.counters["breaker_trips"] >= 1
    assert te.counters["degraded_ticks"] > 0
    assert te.counters["served"] > 0
    assert te.counters == je.counters
    assert_same_state(je.state, te.state, scope)
    _, te2, _ = drive(engines("hybrid", sched, **kw))
    assert te2.counters == te.counters


@pytest.mark.parametrize("plane", ["paging", "object"])
def test_breaker_on_baseline_planes(plane):
    """The degraded plan of each baseline plane under an open breaker."""
    kw = dict(max_retries=1, breaker_threshold=0.5, breaker_probe_every=4)
    je, te = engines(plane, dict(seed=3, outages=((6, 20, -1),)), **kw)
    for ids in batches(30, seed0=5):
        serve_both(je, te, ids)
    je.flush_retries()
    te.flush_retries()
    assert te.counters["degraded_ticks"] > 0
    assert te.counters == je.counters
    assert_same_state(je.state, te.state, plane)


def test_flush_retries_conservation():
    """Heavy faults, few attempts and a small retry queue: overflow and
    exhausted attempts are shed; after flush_retries every offered request
    left exactly once, as served or shed, and the queue is empty."""
    je, te = engines("object", dict(seed=9, fail_prob=0.6), max_retries=2,
                     retry_queue_cap=8)
    offered = 0
    for ids in batches(12, size=12):
        serve_both(je, te, ids)
        offered += ids.size
    je.flush_retries()
    te.flush_retries()
    c = te.counters
    assert not te._retryq
    assert c["served"] + c["shed_requests"] == offered
    assert c["shed_requests"] > 0 and c["fetch_retries"] > 0
    assert c == je.counters
    assert_same_state(je.state, te.state)


def test_pipelined_robust_engine_conserves_requests():
    """Pipelined dispatch (the breaker acts a tick late): every served row
    is the true row and every offered request leaves exactly once."""
    _, te = engines("hybrid", dict(seed=4, fail_prob=0.3), dispatch="pipelined",
                    max_retries=3, breaker_threshold=0.9)
    offered = 0
    futs = []
    for ids in batches(20, size=BATCH - 4):
        futs.append((ids, te.submit(ids)))
        offered += ids.size
    te.drain()
    for ids, rows in futs:
        rows = rows.numpy()
        hit = rows.any(axis=1)
        np.testing.assert_array_equal(rows[hit], DATA[ids[hit]])
    te.flush_retries()
    c = te.counters
    assert c["served"] + c["shed_requests"] == offered
    assert c["fetch_retries"] > 0


def test_watchdog_raises_instead_of_hanging():
    _, te = engines("hybrid", "null", watchdog_s=0.05)

    class NeverReady:
        def ready(self):
            return False

        def wait(self):  # pragma: no cover
            raise AssertionError("watchdog must fire before blocking")

    with pytest.raises(TimeoutError):
        te._wait_ready(NeverReady())


def test_only_sharded_engine_is_refused():
    """No robust engine is refused any more.  The name is the one this
    test had while the sharded engine was the last refused; since the
    sharded far tier was ported, the sharded one (shards=2) serves, and so
    does the object plane's."""
    eng = Engine(EngineConfig(batch=16, shards=2, faults=tfaults.NULL),
                 PlaneConfig(**PLANE), DATA, device="cpu")
    np.testing.assert_array_equal(eng.serve_batch(np.arange(5)).numpy(),
                                  DATA[:5])
    eng = Engine(EngineConfig(plane="object", batch=16, max_retries=1,
                              faults=tfaults.NULL), PlaneConfig(**PLANE),
                 torch.from_numpy(DATA), device="cpu")
    np.testing.assert_array_equal(eng.serve_batch(np.arange(5)).numpy(),
                                  DATA[:5])
