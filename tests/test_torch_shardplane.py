"""The port's sharded far tier against JAX's ``mesh=None`` oracle.

``repro_torch.core.shardplane`` (a Python loop over shard states) is held
to ``repro.core.shardplane`` (a ``vmap`` over the stacked state) at
tests/test_sharded.py's size: 256 global objects of 8 f32, 4 objects a
page, 16 requests a shard.  Each case builds the same config and data in
both packages and drives both through the same accesses (with the served
channel), updates, epochs and evacuations: every returned row and served
flag, every field of every shard (``car_ema`` and ``car_thr`` too: the
JAX plane runs ``kernel_impl="ref"``, whose CAR EMA rounds as the
port's) and every counter, ``ingress_spills`` included, must agree bit
for bit.  Then the shard cases of tests/test_faults.py against JAX, the
engine's ``shards > 1`` path against the JAX engine, and the port's own
oracles (``shards=1`` is the plain plane, the batched executor is the
reference executor).  The mesh path is in tests/test_torch_shardmesh.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import shardplane as jsp
from repro.core.layout import PlaneConfig as JConfig
from repro.kernels import ops as jops
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.core import batch as tbatch
from repro_torch.core import faults as tfaults
from repro_torch.core import plane as tplane
from repro_torch.core import shardplane as tsp
from repro_torch.core import state as tstate
from repro_torch.core.layout import PlaneConfig
from repro_torch.kernels import ops as tops
from repro_torch.serving.engine import Engine, EngineConfig

O, D, R = 256, 8, 16
PLANE = dict(num_objs=O, obj_dim=D, page_objs=4, num_frames=48,
             num_vpages=192)
DATA = np.arange(O * D, dtype=np.float32).reshape(O, D)


def schedules(sched):
    """(JAX schedule, port schedule) from ``Schedule`` keyword arguments,
    "null", or None."""
    if sched is None:
        return None, None
    if sched == "null":
        return jfaults.NULL, tfaults.NULL
    return jfaults.Schedule(**sched), tfaults.Schedule(**sched)


def configs(shards, plane="hybrid", exchange="overlap", budget=None,
            sched=None, batch=R, **kw):
    """(JAX sharded config, port sharded config) over the same plane."""
    js, ts = schedules(sched)
    kw = dict(PLANE, **kw)
    jc = jsp.make_config(JConfig(kernel_impl="ref", faults=js, **kw),
                         shards, batch, budget, plane=plane,
                         exchange=exchange)
    tc = tsp.make_config(PlaneConfig(faults=ts, **kw), shards, batch,
                         budget, plane=plane, exchange=exchange)
    return jc, tc


def assert_same_state(js, ts, ctx=""):
    """The JAX stacked state and the port's shard list, field by field."""
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
        np.testing.assert_array_equal(x, b[k], err_msg=f"{k} {ctx}")


def skewed(shards, steps, seed, n_objs=O):
    """``[steps, shards, R]`` zipf-skewed ids (duplicates, most owned by
    shard 0, so a small budget spills); every third step pads its tail."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.5, size=(steps, shards, R)) % n_objs).astype(np.int32)
    ids[2::3, :, -3:] = -1
    return ids


# --------------------------------------------------------------------------
# the oracle against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shards,plane,exchange,budget", [
    (1, "hybrid", "overlap", None),
    (2, "hybrid", "serial", None),
    (4, "hybrid", "overlap", None),
    (2, "hybrid", "serial", 6),
    (4, "hybrid", "overlap", 3),
    (2, "paging", "overlap", 3),
    (4, "paging", "serial", None),
    (2, "object", "overlap", 3),
    (4, "object", "serial", None),
], ids=lambda v: str(v))
def test_sharded_plane_matches_jax(shards, plane, exchange, budget):
    """access (served channel, padding no-ops, spill rounds), and on the
    hybrid plane update, advance_epoch and evacuate, step by step."""
    jc, tc = configs(shards, plane, exchange, budget)
    js = jsp.create(jc, jnp.asarray(DATA))
    ts = tsp.create(tc, DATA, device="cpu")
    acc = jsp.jitted_access(jc, with_served=True)
    hybrid = plane == "hybrid"
    if hybrid:
        upd = jsp.jitted_update(jc)
        ep = jsp.jitted_advance_epoch(jc)
        ev = jsp.jitted_evacuate(jc, garbage_threshold=-1.0, max_pages=4)
    rng = np.random.default_rng(7)
    written = np.zeros((O,), bool)
    for t, ids in enumerate(skewed(shards, 8, seed=shards)):
        js, jr, jv = acc(js, jnp.asarray(ids))
        ts, tr, tv = tsp.access(tc, ts, torch.from_numpy(ids),
                                with_served=True)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                      err_msg=f"rows t={t}")
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                      err_msg=f"served t={t}")
        clean = (ids >= 0) & ~written[ids]         # rows never rewritten
        np.testing.assert_array_equal(tr.numpy()[clean], DATA[ids[clean]],
                                      err_msg=f"truth t={t}")
        assert not tr.numpy()[ids < 0].any()
        if hybrid and t % 2:
            written[ids[ids >= 0]] = True
            rows = rng.normal(size=(shards, R, D)).astype(np.float32)
            js = upd(js, jnp.asarray(ids), jnp.asarray(rows))
            tsp.update(tc, ts, torch.from_numpy(ids), torch.from_numpy(rows))
        if hybrid and t % 3 == 1:
            js = ev(ep(js))
            tsp.evacuate(tc, tsp.advance_epoch(tc, ts),
                         garbage_threshold=-1.0, max_pages=4)
        assert_same_state(js, ts, f"t={t}")
    total = tsp.stats_total(ts)
    assert (int(total.ingress_spills) > 0) == (budget is not None
                                               and shards > 1)
    assert all(tsp.check_invariants(tc, ts).values())
    if hybrid:
        thr = [float(s.car_thr) for s in ts]
        assert thr == [thr[0]] * shards          # the governor in lockstep
        assert int(total.epochs) == 3 * shards
    if plane == "object" and budget is None:
        assert int(total.obj_outs) > 0           # the reclaim loop ran
    assert float(tsp.paging_fraction(tc, ts)) == float(
        jsp.paging_fraction(jc, js))


def test_four_frame_shards_serve_as_jax_does():
    """The launcher's recipe at 512 objects over 4 shards leaves each
    shard 4 frames, the fewest a plane may have.  There the reference
    plane itself serves some requests another object's row (ROADMAP
    Queue 3); the port serves what JAX serves, row for row, and its state
    is JAX's."""
    kw = dict(num_objs=512, obj_dim=32, page_objs=8, num_frames=16,
              num_vpages=192, readahead=2)
    jc, tc = configs(4, batch=8, **kw)
    assert tc.shard.num_frames == 4
    data = np.random.default_rng(0).random((512, 32), np.float32)
    js = jsp.create(jc, jnp.asarray(data))
    ts = tsp.create(tc, data, device="cpu")
    acc = jsp.jitted_access(jc)
    ep = jsp.jitted_advance_epoch(jc)
    ev = jsp.jitted_evacuate(jc, garbage_threshold=-1.0, max_pages=4)
    rng = np.random.default_rng(1)
    for t in range(24):
        ids = np.minimum(rng.zipf(1.3, size=(4, 8)) - 1, 511).astype(
            np.int32)
        js, jr = acc(js, jnp.asarray(ids))
        ts, tr = tsp.access(tc, ts, torch.from_numpy(ids))
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                      err_msg=f"t={t}")
        if t % 6 == 5:
            js = ev(ep(js))
            tsp.evacuate(tc, tsp.advance_epoch(tc, ts),
                         garbage_threshold=-1.0, max_pages=4)
    assert_same_state(js, ts, "four frames a shard")


@pytest.mark.parametrize("idx,want", [
    ([3, 0, 3, 0], [9, 9, 3, 0]),
    ([5, 5, 5, 5], [9, 9, 9, 5]),
    ([0, 1, 2, 3], [0, 1, 2, 3]),
    ([9, 2, 9, 2], [9, 9, 9, 2]),
])
def test_last_writes_keeps_only_the_last_duplicate(idx, want):
    """The evacuation's frame scatter: every write but the last to a frame
    goes to the trash frame (9 here), so the write JAX keeps is the only
    one left, whatever order the card applies them in."""
    got = tplane.last_writes(torch.tensor(idx, dtype=torch.int32), 9)
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_through_last_writes_is_the_ordered_scatter(seed):
    """Writing through ``last_writes`` leaves no duplicate but the trash
    and gives numpy's in-order scatter (JAX's ``.at[].set``)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 3, size=4).astype(np.int32)
    rows = rng.random((4, 5), np.float32)
    want = np.zeros((4, 5), np.float32)
    for i, r in zip(idx, rows):
        want[i] = r
    t = tplane.last_writes(torch.from_numpy(idx), 3)
    kept = t[t != 3]
    assert len(set(kept.tolist())) == len(kept)
    got = torch.zeros((4, 5))
    got[t] = torch.from_numpy(rows)
    np.testing.assert_array_equal(got[:3].numpy(), want[:3])


def test_four_frame_evacuation_writes_duplicate_frames(monkeypatch):
    """The four-frame trace above does reach two destinations on one
    frame, the case ``last_writes`` orders."""
    seen, real = [], tplane.last_writes

    def spy(idx, trash):
        live = idx[idx != trash]
        seen.append(len(set(live.tolist())) < len(live))
        return real(idx, trash)
    monkeypatch.setattr(tplane, "last_writes", spy)
    kw = dict(num_objs=512, obj_dim=32, page_objs=8, num_frames=16,
              num_vpages=192, readahead=2)
    _, tc = configs(4, batch=8, **kw)
    data = np.random.default_rng(0).random((512, 32), np.float32)
    ts = tsp.create(tc, data, device="cpu")
    rng = np.random.default_rng(1)
    for t in range(24):
        ids = np.minimum(rng.zipf(1.3, size=(4, 8)) - 1, 511).astype(
            np.int32)
        tsp.access(tc, ts, torch.from_numpy(ids))
        if t % 6 == 5:
            tsp.evacuate(tc, tsp.advance_epoch(tc, ts),
                         garbage_threshold=-1.0, max_pages=4)
    assert seen and any(seen)


def test_padding_only_batches_and_update_read_back():
    """An all-padding batch is a no-op on rows; updated rows read back
    through the exchange (test_sharded's padding and read-back cases)."""
    shards = 2
    jc, tc = configs(shards, exchange="serial")
    js = jsp.create(jc, jnp.asarray(DATA))
    ts = tsp.create(tc, DATA, device="cpu")
    acc = jsp.jitted_access(jc, with_served=True)
    ids = np.full((shards, R), -1, np.int32)
    ids[0, 0], ids[1, 3] = 7, 200
    js, jr, _ = acc(js, jnp.asarray(ids))
    ts, tr, tv = tsp.access(tc, ts, torch.from_numpy(ids), with_served=True)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert tv.sum() == 2 and (tr.numpy()[ids < 0] == 0).all()
    total = tsp.stats_total(ts)
    assert int(total.hits) + int(total.misses) == 2
    rng = np.random.default_rng(6)
    ids = rng.permutation(O)[:shards * R].reshape(shards, R).astype(np.int32)
    rows = rng.normal(size=(shards, R, D)).astype(np.float32)
    js = jsp.jitted_update(jc)(js, jnp.asarray(ids), jnp.asarray(rows))
    tsp.update(tc, ts, torch.from_numpy(ids), torch.from_numpy(rows))
    js, jr, _ = acc(js, jnp.asarray(ids))
    ts, tr = tsp.access(tc, ts, torch.from_numpy(ids))
    np.testing.assert_array_equal(tr.numpy(), rows)
    np.testing.assert_array_equal(np.asarray(jr), rows)
    assert_same_state(js, ts, "read back")


def test_payload_helpers_round_trip_like_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 99, size=(3, 2, 5)).astype(np.int32)
    cnt = rng.integers(0, 4, size=(3, 2, 5)).astype(np.int32)
    jp = jops.fuse_ids_counts(jnp.asarray(ids), jnp.asarray(cnt))
    tp = tops.fuse_ids_counts(torch.from_numpy(ids), torch.from_numpy(cnt))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    for x, y in zip(tops.split_ids_counts(tp), (ids, cnt)):
        np.testing.assert_array_equal(x.numpy(), y)
    rows = rng.normal(size=(3, 2, 5, 4)).astype(np.float32)
    flags = rng.random((3, 2, 5)) < 0.5
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jp = jops.fuse_rows_flags(jnp.asarray(rows, jdt), jnp.asarray(flags))
        tp = tops.fuse_rows_flags(torch.from_numpy(rows).to(tdt),
                                  torch.from_numpy(flags))
        assert tp.dtype == tdt and tp.shape == (3, 2, 5, 5)
        np.testing.assert_array_equal(np.asarray(jp, np.float32),
                                      tp.float().numpy())
        r, f = tops.split_rows_flags(tp)
        assert f.dtype == torch.bool
        np.testing.assert_array_equal(f.numpy(), flags)
        np.testing.assert_array_equal(
            r.float().numpy(), np.asarray(jnp.asarray(rows, jdt), np.float32))


# --------------------------------------------------------------------------
# the port's own oracles
# --------------------------------------------------------------------------

def test_shards1_is_the_plain_port_plane():
    """shards=1 with the default budget: the exchange wraps the plain
    plane, rows, state and every counter alike."""
    _, tc = configs(1)
    ts = tsp.create(tc, DATA, device="cpu")
    plain = tstate.create(tc.shard, DATA, device="cpu")
    rng = np.random.default_rng(3)
    for t in range(12):
        ids = rng.integers(0, O, size=R).astype(np.int32)
        ids[1] = ids[0]                             # duplicates
        ids_t = torch.from_numpy(ids)
        ts, rs = tsp.access(tc, ts, ids_t[None])
        _, rp = tbatch.access(tc.shard, plain, ids_t)
        assert torch.equal(rs[0], rp), t
        rows = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
        tsp.update(tc, ts, ids_t[None], rows[None])
        tbatch.update(tc.shard, plain, ids_t, rows)
    a, b = convert.state_to_numpy(ts), convert.state_to_numpy([plain])
    for k in a:
        if k != "stats":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in a["stats"]:
        np.testing.assert_array_equal(a["stats"][k], b["stats"][k],
                                      err_msg=k)


@pytest.mark.parametrize("plane", ["hybrid", "paging", "object"])
def test_sharded_batch_matches_reference(plane):
    """mode="batch" == mode="reference" through the exchange."""
    _, tc = configs(2, plane, budget=5)
    sb = tsp.create(tc, DATA, device="cpu")
    sr = tsp.create(tc, DATA, device="cpu")
    for ids in skewed(2, 5, seed=21):
        ids_t = torch.from_numpy(ids)
        sb, rb = tsp.access(tc, sb, ids_t, mode="batch")
        sr, rr = tsp.access(tc, sr, ids_t, mode="reference")
        assert torch.equal(rb, rr)
    a, b = convert.state_to_numpy(sb), convert.state_to_numpy(sr)
    for k in a:
        if k != "stats":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_create_sharded_copies_and_entry_points_default_to_cuda():
    _, tc = configs(2)
    data = torch.from_numpy(DATA.copy())
    ts = tsp.create(tc, data, device="cpu")
    assert len(ts) == 2 and tstate.shard_slice(ts, 1) is ts[1]
    data.zero_()                               # each slab is its own copy
    _, rows = tsp.access(tc, ts, torch.tensor([[5, 200] + [-1] * 14] * 2,
                                              dtype=torch.int32))
    np.testing.assert_array_equal(rows[:, :2].numpy(), DATA[[[5, 200]] * 2])
    with pytest.raises(ValueError, match="shards hold"):
        tstate.create_sharded(tc.shard, 3, DATA, device="cpu")
    if torch.cuda.is_available():
        return
    for call in (lambda: tsp.create(tc, DATA),
                 lambda: Engine(EngineConfig(batch=16, shards=2),
                                PlaneConfig(**PLANE), DATA)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------
# the shard cases of tests/test_faults.py, against JAX
# --------------------------------------------------------------------------

FAULT_PLANE = dict(obj_dim=4, page_objs=8)


def fault_configs(shards, sched):
    return configs(shards, sched=sched, num_objs=96 * shards,
                   num_frames=6 * shards, num_vpages=40 * shards,
                   **FAULT_PLANE)


def fault_data(n):
    return np.arange(n * 4, dtype=np.float32).reshape(n, 4)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_soak_served_and_determinism(shards):
    """20% fetch failures: rows, served verdicts and state equal JAX's
    every tick, and a same-seed rerun of the port replays them."""
    jc, tc = fault_configs(shards, dict(seed=13, fail_prob=0.2))
    n = tc.num_objs
    acc = jsp.jitted_access(jc, with_served=True)

    def soak(check_jax):
        js = jsp.create(jc, jnp.asarray(fault_data(n)))
        ts = tsp.create(tc, fault_data(n), device="cpu")
        rng = np.random.RandomState(2)
        sv_all = []
        for t in range(10):
            ids = rng.randint(0, n, size=(shards, 16)).astype(np.int32)
            ts, rows, sv = tsp.access(tc, ts, torch.from_numpy(ids),
                                      with_served=True)
            assert rows.shape == (shards, 16, 4)
            if check_jax:
                js, jr, jv = acc(js, jnp.asarray(ids))
                np.testing.assert_array_equal(np.asarray(jr), rows.numpy())
                np.testing.assert_array_equal(np.asarray(jv), sv.numpy())
                assert_same_state(js, ts, f"soak S={shards} t={t}")
            sv_all.append(sv.numpy())
        assert all(tsp.check_invariants(tc, ts).values())
        return ts, np.stack(sv_all)

    ts_a, sv_a = soak(True)
    ts_b, sv_b = soak(False)
    np.testing.assert_array_equal(sv_a, sv_b)
    a, b = convert.state_to_numpy(ts_a), convert.state_to_numpy(ts_b)
    for k in a:
        if k != "stats":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(tsp.stats_total(ts_a).fetch_failures) > 0
    assert not sv_a.all(), "no request was ever fault-masked"


def test_sharded_outage_hits_only_scheduled_shard():
    jc, tc = configs(2, sched=dict(seed=3, outages=((1, 12, 1),)),
                     num_objs=192, num_frames=12, num_vpages=80,
                     **FAULT_PLANE)
    data = fault_data(192)
    js = jsp.create(jc, jnp.asarray(data))
    ts = tsp.create(tc, data, device="cpu")
    acc = jsp.jitted_access(jc, with_served=True)
    rng = np.random.RandomState(4)
    for _ in range(8):
        ids = rng.randint(0, 192, size=(2, 16)).astype(np.int32)
        js, jr, _ = acc(js, jnp.asarray(ids))
        ts, tr, _ = tsp.access(tc, ts, torch.from_numpy(ids),
                               with_served=True)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert_same_state(js, ts, "outage")
    per_shard = [int(s.stats.fetch_failures) for s in ts]
    assert per_shard[1] > 0, "outage shard saw no failures"
    assert per_shard[0] == 0, "outage leaked onto a healthy shard"


def test_per_shard_degmask_healthy_shard_bit_identical():
    """Shard 0 degraded by the [S] mask: every request owned by shard 1
    (rows, verdicts, its state) equals the fault-free run, and an
    all-False mask is the plain program, here and in JAX alike."""
    jc, tc = configs(2, num_objs=192, num_frames=12, num_vpages=80,
                     **FAULT_PLANE)
    data = fault_data(192)
    fn_deg = jsp.jitted_access_degmask(jc, with_served=True)
    ta, tb, tcc = (tsp.create(tc, data, device="cpu") for _ in range(3))
    ja = jsp.create(jc, jnp.asarray(data))
    dmask = np.asarray([True, False])
    none = torch.zeros((2,), dtype=torch.bool)
    deg_fn = tsp.jitted_access_degmask(tc)
    pln_fn = tsp.jitted_access(tc, with_served=True)
    rng = np.random.RandomState(5)
    degraded_masked = False
    for t in range(8):
        ids = rng.randint(0, 192, size=(2, 16)).astype(np.int32)
        ids_t = torch.from_numpy(ids)
        ja, jr, jv = fn_deg(ja, jnp.asarray(ids), jnp.asarray(dmask))
        ta, r_a, v_a = deg_fn(ta, ids_t, torch.from_numpy(dmask))
        tb, r_b, v_b = pln_fn(tb, ids_t)
        tcc, r_c, v_c = deg_fn(tcc, ids_t, none)
        np.testing.assert_array_equal(np.asarray(jr), r_a.numpy())
        np.testing.assert_array_equal(np.asarray(jv), v_a.numpy())
        assert torch.equal(r_c, r_b) and torch.equal(v_c, v_b), t
        own1 = ids // tc.shard.num_objs == 1
        np.testing.assert_array_equal(r_a.numpy()[own1], r_b.numpy()[own1])
        np.testing.assert_array_equal(v_a.numpy()[own1], v_b.numpy()[own1])
        degraded_masked |= bool((~v_a.numpy()[~own1]).any())
    assert degraded_masked, "degraded shard never masked a request"
    assert_same_state(ja, ta, "degmask")
    a, b, c = (convert.state_to_numpy(x) for x in (ta, tb, tcc))
    for k in b:
        if k != "stats":
            np.testing.assert_array_equal(c[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=k)


# --------------------------------------------------------------------------
# the engine's shards > 1 path against the JAX engine
# --------------------------------------------------------------------------

ENGINE_PLANE = dict(num_objs=256, obj_dim=8, page_objs=8, num_vpages=96)
ENGINE_DATA = np.arange(256 * 8, dtype=np.float32).reshape(256, 8)


def engines(shards, sched=None, plane="hybrid", batch=16, frames=12,
            **ekw):
    js, ts = schedules(sched)
    pkw = dict(ENGINE_PLANE, num_frames=frames)
    je = JEngine(JEngineConfig(plane=plane, batch=batch, dispatch="sync",
                               shards=shards, faults=js, **ekw),
                 JConfig(kernel_impl="ref", **pkw), jnp.asarray(ENGINE_DATA))
    te = Engine(EngineConfig(plane=plane, batch=batch, dispatch="sync",
                             shards=shards, faults=ts, **ekw),
                PlaneConfig(**pkw), ENGINE_DATA, device="cpu")
    return je, te


@pytest.mark.parametrize("plane,ekw", [
    ("hybrid", dict(evac_every=8, epoch_every=10)),
    ("hybrid", dict(evac_budget=4, evac_every=8, epoch_every=50,
                    epoch_watermark_bytes=2048, shard_budget=3,
                    shard_exchange="serial")),
    ("object", dict()),
], ids=["evac-epoch", "slices-watermark-spill", "object"])
def test_sharded_engine_matches_jax_engine(plane, ekw):
    """Engine(shards=4): every tick's rows, the final state of every shard
    and the run report equal the JAX engine's."""
    je, te = engines(4, plane=plane, batch=32, frames=24, **ekw)
    rng = np.random.RandomState(51)
    for t in range(24):
        n = 32 if t % 5 else 27                 # short batches pad
        ids = rng.randint(0, 256, size=n).astype(np.int32)
        jr = je.serve_batch(ids)
        tr = te.serve_batch(ids)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                      err_msg=f"t={t}")
        np.testing.assert_array_equal(tr.numpy(), ENGINE_DATA[ids])
    assert_same_state(je.state, te.state, f"engine {plane}")
    jrep, trep = je.run([]), te.run([])
    for k in ("stats", "counters", "fetch_failures_per_shard",
              "egress_failures_per_shard", "served_per_shard",
              "paging_fraction"):
        assert jrep[k] == trep[k], k


def test_engine_per_shard_breaker_isolates_faulty_shard():
    """tests/test_faults.py's case, and against the JAX engine: a
    single-shard outage trips only that shard's breaker, which closes
    again; the healthy shard's goodput holds; same-seed runs give the same
    counters; the global scope trips both shards and costs the healthy
    one.  The faulted runs equal the JAX engine's tick by tick."""
    sched = dict(seed=7, outages=((6, 46, 0),))
    kw = dict(max_retries=1, breaker_threshold=0.5, breaker_probe_every=4)

    def drive(scope, faulted=True, vs_jax=False):
        je, te = engines(2, sched if faulted else "null",
                         breaker_scope=scope, **kw)
        open_seen = np.zeros((2,), bool)
        for s in range(70):
            ids = np.random.RandomState(s).randint(0, 256, size=16).astype(
                np.int32)
            tr = te.submit(ids)
            te.drain()
            if vs_jax:
                jr = je.submit(ids)
                je.drain()
                np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                              err_msg=f"{scope} tick {s}")
                np.testing.assert_array_equal(je.breaker_open_shards,
                                              te.breaker_open_shards)
            open_seen |= te.breaker_open_shards
        te.flush_retries()
        if vs_jax:
            je.flush_retries()
            assert je.counters == te.counters
            np.testing.assert_array_equal(je.served_per_shard,
                                          te.served_per_shard)
            assert_same_state(je.state, te.state, f"breaker {scope}")
        return te, open_seen

    eng, open_seen = drive("shard", vs_jax=True)
    assert open_seen[0], "faulty shard's breaker never opened"
    assert not open_seen[1], "outage leaked into the healthy shard's breaker"
    assert not eng.breaker_open, "breaker failed to close after recovery"
    assert eng.counters["breaker_trips"] >= 1
    assert eng.counters["degraded_ticks"] > 0
    eng_ok, _ = drive("shard", faulted=False)
    assert (eng.served_per_shard[1]
            >= 0.9 * eng_ok.served_per_shard[1]), (eng.served_per_shard,
                                                   eng_ok.served_per_shard)
    eng2, _ = drive("shard")
    assert eng.counters == eng2.counters
    np.testing.assert_array_equal(eng.served_per_shard,
                                  eng2.served_per_shard)
    eng_g, open_g = drive("global", vs_jax=True)
    assert open_g.all(), "global scope must trip every shard together"
    assert eng_g.served_per_shard[1] < eng.served_per_shard[1]
    assert eng.run([])["fetch_failures_per_shard"][1] == 0
