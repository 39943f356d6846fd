"""The sharded far tier's mesh path over ``torch.distributed`` against the
port's loop oracle, on the CPU (gloo).

Each spawn starts S ranks (S = 2 and S = 4) as Python processes that meet
through a ``file://`` rendezvous under the test's ``tmp_path`` (parallel
test workers never share a port).  Every rank builds the loop oracle's S
shards beside its own mesh shard (``launch.mesh.put_far``), drives both
through the same calls and holds its rows block, its served block and its
shard's whole state to the oracle's bit for bit:

* ``jitted_access`` (overlap and serial, a spilling budget, padded ids, a
  fault schedule with an outage on one shard), ``jitted_update``,
  ``jitted_advance_epoch`` and ``jitted_evacuate`` on the hybrid plane,
  and accesses on the paging and object planes;
* ``jitted_access_degmask`` with a mask that trips shard 0, then an
  all-False one;
* ``phase_probe`` (both phases, with and without spills) against the
  loop oracle's checksums;
* the KV plane's ``jitted_sharded_decode`` against the loop decode;
* ``Engine(shards=S, group=...)`` against the loop engine, with the fault
  schedule and the per-shard breaker: every tick's rows (whole on every
  rank), the counters, the breaker states and the run report.

A rank whose check fails exits non-zero; the parent then kills the other
ranks and fails.  Each spawn has a hard limit of 120 s.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120

O, D, R = 256, 8, 16
PLANE = dict(num_objs=O, obj_dim=D, page_objs=4, num_frames=48,
             num_vpages=192)
DATA = np.arange(O * D, dtype=np.float32).reshape(O, D)
SCHED = dict(seed=17, fail_prob=0.2, egress_prob=0.1, outages=((3, 7, 1),))


def spawn(tmp_path: Path, world: int) -> list:
    """Run this file as ``world`` ranks; returns each rank's output.  Fails
    (after killing every rank) when a rank fails or the spawn outlives
    SPAWN_TIMEOUT_S."""
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), str(world), init],
                    stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT)))
        deadline = time.time() + SPAWN_TIMEOUT_S
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs):
                break
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad or time.time() > deadline:
                why = (f"rank {bad[0]} exited {rcs[bad[0]]}" if bad else
                       f"timed out after {SPAWN_TIMEOUT_S}s")
                tail = logs[bad[0] if bad else 0].read_text()[-4000:]
                pytest.fail(f"{world}-rank spawn: {why}\n{tail}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [log.read_text() for log in logs]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_path_equals_loop_oracle(tmp_path, world):
    outs = spawn(tmp_path, world)
    for r, out in enumerate(outs):
        assert f"rank {r}/{world}: all checks passed" in out, out[-2000:]


def test_make_far_group_needs_a_process_group():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_far_group(2)


# --------------------------------------------------------------------------
# the rank's side
# --------------------------------------------------------------------------

def _same_state(a, b, ctx):
    from repro_torch import convert
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for k in x:
        if k == "stats":
            for kk in x[k]:
                np.testing.assert_array_equal(x[k][kk], y[k][kk],
                                              err_msg=f"stats.{kk} {ctx}")
        else:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{k} {ctx}")


def _ids(rng, S, pad=False):
    ids = (rng.zipf(1.5, size=(S, R)) % O).astype(np.int32)
    if pad:
        ids[:, -3:] = -1
    return torch.from_numpy(ids)


def check_plane(g, S, me):
    """access/update/epoch/evacuate through the group == the loop oracle;
    the degraded-mask access too."""
    from repro_torch.core import faults, shardplane as sp
    from repro_torch.core.layout import PlaneConfig
    from repro_torch.launch import mesh
    cases = [("hybrid", "overlap", 3, SCHED), ("hybrid", "serial", None,
                                                None),
             ("paging", "serial", 3, None), ("object", "overlap", None,
                                             SCHED)]
    for plane, exchange, budget, sched in cases:
        pcfg = PlaneConfig(faults=faults.Schedule(**sched) if sched else None,
                           **PLANE)
        cfg = sp.make_config(pcfg, S, R, budget, plane=plane,
                             exchange=exchange)
        so = sp.create(cfg, DATA, device="cpu")
        sm = mesh.put_far(sp.create(cfg, DATA, device="cpu"), g)
        assert sm[me] is not None and sum(x is None for x in sm) == S - 1
        acc = [sp.jitted_access(cfg, group=x, with_served=True)
               for x in (None, g)]
        upd = [sp.jitted_update(cfg, group=x) for x in (None, g)]
        ep = [sp.jitted_advance_epoch(cfg, x) for x in (None, g)]
        ev = [sp.jitted_evacuate(cfg, garbage_threshold=-1.0, max_pages=4,
                                 group=x) for x in (None, g)]
        rng = np.random.default_rng(S)
        for t in range(8):
            ids = _ids(rng, S, pad=t % 3 == 2)
            so, ro, vo = acc[0](so, ids)
            sm, rm, vm = acc[1](sm, ids)
            ctx = f"{plane}/{exchange}/{budget} t={t}"
            assert rm.shape == (R, D) and torch.equal(rm, ro[me]), ctx
            assert torch.equal(vm, vo[me]), ctx
            if plane == "hybrid" and t % 2:
                rows = torch.from_numpy(rng.normal(size=(S, R, D)).astype(
                    np.float32))
                upd[0](so, ids, rows)
                upd[1](sm, ids, rows)
            if plane == "hybrid" and t % 3 == 1:
                ev[0](ep[0](so))
                ev[1](ep[1](sm))
            _same_state(sm[me], so[me], ctx)
        if budget is not None:
            assert int(sp.stats_total(so).ingress_spills) > 0
        tot_o, tot_m = sp.stats_total(so), sp.stats_total(sm, g)
        for k in tot_o._fields:
            assert int(getattr(tot_o, k)) == int(getattr(tot_m, k)), k
        assert float(sp.paging_fraction(cfg, so)) == float(
            sp.paging_fraction(cfg, sm, g))
        assert all(sp.check_invariants(cfg, sm).values())
    # the per-shard breaker's access: shard 0 tripped, then no shard
    cfg = sp.make_config(PlaneConfig(faults=faults.Schedule(**SCHED),
                                     **PLANE), S, R)
    so = sp.create(cfg, DATA, device="cpu")
    sm = mesh.put_far(sp.create(cfg, DATA, device="cpu"), g)
    dm = [sp.jitted_access_degmask(cfg, group=x) for x in (None, g)]
    rng = np.random.default_rng(5)
    for t in range(6):
        ids = _ids(rng, S)
        deg = torch.zeros((S,), dtype=torch.bool)
        deg[0] = t % 2 == 0
        so, ro, vo = dm[0](so, ids, deg)
        sm, rm, vm = dm[1](sm, ids, deg)
        assert torch.equal(rm, ro[me]) and torch.equal(vm, vo[me]), t
        _same_state(sm[me], so[me], f"degmask t={t}")


def check_probe(g, S, me):
    """phase_probe through the group == this rank's entry of the loop
    oracle's checksums, both phases, with and without spills."""
    from repro_torch.core import shardplane as sp
    from repro_torch.core.layout import PlaneConfig
    rng = np.random.default_rng(11)
    for budget in (None, 3):
        cfg = sp.make_config(PlaneConfig(**PLANE), S, R, budget)
        ids = _ids(rng, S, pad=True)
        for phase in ("pack", "ingress"):
            want = sp.phase_probe(cfg, phase)(ids)
            got = sp.phase_probe(cfg, phase, g)(ids)
            assert got.shape == (1,) and int(got[0]) == int(want[me]), \
                (phase, budget, got, want)


def check_kv_decode(g, S, me):
    """jitted_sharded_decode through the group == the loop decode."""
    from repro_torch.core import kvplane as kv
    cfg = kv.KVPlaneConfig(kv_heads=1, head_dim=8, page_tokens=4,
                           num_pages=8, num_frames=3, batch=1, sparse_topk=3,
                           fetch_budget=2, car_threshold=0.5,
                           dtype=torch.float32)
    so = [kv.init(cfg, "cpu") for _ in range(S)]
    full = [kv.init(cfg, "cpu") for _ in range(S)]
    # this rank attends its own shard (the same object the appends write)
    sm = [s if i == me else None for i, s in enumerate(full)]
    dec = [kv.jitted_sharded_decode(cfg, group=x) for x in (None, g)]
    gen = torch.Generator().manual_seed(S)
    for t in range(6 * S):
        kn, vn = (torch.randn((1, 1, 8), generator=gen) for _ in range(2))
        L = torch.tensor([t], dtype=torch.int32)
        kv.append_sharded(cfg, so, kn, vn, L)
        kv.append_sharded(cfg, full, kn, vn, L)
        if t % 3 == 2:
            q = torch.randn((1, 1, 8), generator=gen)
            oo, so = dec[0](so, q, L + 1)
            om, sm = dec[1](sm, q, L + 1)
            assert torch.equal(oo, om), f"decode t={t}"
    from repro_torch import convert
    a = convert.kv_state_to_numpy(cfg, sm[me])
    b = convert.kv_state_to_numpy(cfg, so[me])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"kv {k}")


def check_engine(g, S, me):
    """Engine(shards=S, group=g) == the loop engine: rows whole on every
    rank, counters, breaker, report."""
    from repro_torch.core import faults
    from repro_torch.core.layout import PlaneConfig
    from repro_torch.serving.engine import Engine, EngineConfig
    pcfg = PlaneConfig(**PLANE)
    ecfg = EngineConfig(plane="hybrid", batch=R * S, dispatch="sync",
                        shards=S, evac_every=6, epoch_every=5,
                        faults=faults.Schedule(seed=7,
                                               outages=((4, 14, 0),)),
                        max_retries=1, breaker_threshold=0.5,
                        breaker_probe_every=4)
    eo = Engine(ecfg, pcfg, DATA, device="cpu")
    em = Engine(ecfg, pcfg, DATA, group=g)
    rng = np.random.RandomState(S)
    tripped = False
    for t in range(24):
        ids = rng.randint(0, O, size=R * S - (t % 4)).astype(np.int32)
        ro, rm = eo.serve_batch(ids), em.serve_batch(ids)
        assert torch.equal(ro, rm), f"engine rows t={t}"
        assert (eo.breaker_open_shards == em.breaker_open_shards).all(), t
        tripped |= bool(em.breaker_open_shards[0])
    eo.flush_retries()
    em.flush_retries()
    assert tripped, "the outage never tripped shard 0's breaker"
    assert eo.counters == em.counters
    assert (eo.served_per_shard == em.served_per_shard).all()
    _same_state(em.state[me], eo.state[me], "engine")
    ra, rb = eo.run([]), em.run([])
    for k in ("stats", "counters", "fetch_failures_per_shard",
              "egress_failures_per_shard", "served_per_shard",
              "paging_fraction"):
        assert ra[k] == rb[k], k


def _rank_main(rank: int, world: int, init: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh
    torch.set_num_threads(1)
    dev = mesh.init_far(rank, world, init, device="cpu")
    assert dev.type == "cpu"
    try:
        g = mesh.make_far_group(world)
        assert mesh.far_device(g).type == "cpu"
        with pytest.raises(ValueError, match="ranks"):
            mesh.make_far_group(world + 1)
        check_plane(g, world, rank)
        check_probe(g, world, rank)
        check_kv_decode(g, world, rank)
        check_engine(g, world, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}/{world}: all checks passed", flush=True)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
