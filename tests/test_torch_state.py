"""The port's plane state, state conversion and fault schedule against the
JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import state as jstate
from repro.core.layout import PlaneConfig as JConfig
from repro_torch import convert
from repro_torch.core import faults as tfaults
from repro_torch.core import state as tstate
from repro_torch.core.layout import PlaneConfig

CONFIGS = [
    dict(num_objs=96, obj_dim=4, page_objs=8, num_frames=6, num_vpages=40),
    # a partial last data page, runtime-path birth
    dict(num_objs=61, obj_dim=8, page_objs=4, num_frames=5, num_vpages=24,
         psf_init_paging=False, car_threshold=0.6),
]


def jax_state_numpy(s) -> dict:
    """A JAX PlaneState as the dict ``convert.state_to_numpy`` returns."""
    d = jax.device_get(s)._asdict()
    d["stats"] = {k: np.asarray(v) for k, v in d["stats"]._asdict().items()}
    return {k: (v if k == "stats" else np.asarray(v)) for k, v in d.items()}


def assert_same_numpy_state(a: dict, b: dict, ctx=""):
    assert list(a) == list(b), ctx
    for k in a:
        if k == "stats":
            assert list(a[k]) == list(b[k])
            for kk in a[k]:
                np.testing.assert_array_equal(a[k][kk], b[k][kk],
                                              err_msg=f"stats.{kk} {ctx}")
            continue
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype, ctx)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {ctx}")


@pytest.mark.parametrize("kw", CONFIGS)
def test_create_matches_jax_field_by_field(kw):
    data = np.random.RandomState(0).randn(kw["num_objs"], kw["obj_dim"]
                                          ).astype(np.float32)
    js = jstate.create(JConfig(**kw), jnp.asarray(data))
    ts = tstate.create(PlaneConfig(**kw), torch.from_numpy(data),
                       device="cpu")
    assert tstate.PlaneState._fields == jstate.PlaneState._fields
    assert tstate.PlaneStats._fields == jstate.PlaneStats._fields
    assert_same_numpy_state(jax_state_numpy(js), convert.state_to_numpy(ts))
    # every padded field carries exactly one trash row
    for name, dim in tstate.PADDED.items():
        n = {"V": kw["num_vpages"], "F": kw["num_frames"],
             "O": kw["num_objs"]}[dim]
        assert getattr(ts, name).shape[0] == n + 1, name


@pytest.mark.parametrize("kw", CONFIGS)
def test_convert_round_trips(kw):
    """JAX state -> port -> numpy is the identity, and so is port ->
    numpy -> port; a converted state is an independent copy."""
    rng = np.random.RandomState(1)
    data = rng.randn(kw["num_objs"], kw["obj_dim"]).astype(np.float32)
    cfg = PlaneConfig(**kw)
    js = jstate.create(JConfig(**kw), jnp.asarray(data))
    # perturb a few fields so the round trip is not of a fresh state
    js = js._replace(clock=js.clock.at[3].set(7), car_thr=jnp.float32(0.7),
                     stats=jstate.bump(js.stats, hits=5))
    ts = convert.state_from_numpy(cfg, jax.device_get(js), device="cpu")
    assert_same_numpy_state(jax_state_numpy(js), convert.state_to_numpy(ts))
    back = convert.state_from_numpy(cfg, convert.state_to_numpy(ts), "cpu")
    assert_same_numpy_state(convert.state_to_numpy(ts),
                            convert.state_to_numpy(back))
    copy = ts.clone()
    copy.slab[0, 0, 0] += 1.0
    copy.stats.hits += 1
    assert int(ts.stats.hits) == 5 and int(copy.stats.hits) == 6
    assert ts.slab[0, 0, 0] != copy.slab[0, 0, 0]


def test_bump_keeps_int32():
    s = tstate.PlaneStats.zeros("cpu")
    tstate.bump(s, hits=3, misses=torch.tensor(2, dtype=torch.int64))
    assert int(s.hits) == 3 and int(s.misses) == 2
    assert s.hits.dtype == s.misses.dtype == torch.int32


SCHEDULES = [
    dict(seed=7, fail_prob=0.3),
    dict(seed=3, fail_prob=0.25, fail_window=(5, 40), egress_prob=0.4),
    dict(seed=11, egress_prob=0.2, egress_window=(0, 30),
         outages=((10, 20, 1), (50, 55, -1)), fail_at=(33,)),
    dict(seed=0x7EADBEEF, fail_prob=0.9, egress_prob=0.05),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_predicates_match_jax(kw):
    """fetch_fail / egress_fail (device) and fails / fails_egress / spike
    (host) agree bit for bit with JAX over a sweep of tick, key and shard,
    keys covering negative ids and the top of the uint32 range."""
    js, ts = jfaults.Schedule(**kw), tfaults.Schedule(**kw)
    assert (js.active, js.egress_active) == (ts.active, ts.egress_active)
    keys = np.concatenate([np.arange(-3, 200), [2 ** 31 - 1, 123456789]]
                          ).astype(np.int32)
    kj, kt = jnp.asarray(keys), torch.from_numpy(keys)
    for shard in (0, 1, 3):
        for tick in range(0, 64, 3):
            np.testing.assert_array_equal(
                np.asarray(js.fetch_fail(tick, kj, shard)),
                ts.fetch_fail(tick, kt, shard).numpy(),
                err_msg=f"fetch_fail tick={tick} shard={shard}")
            # the plane passes the tick as a 0-d int32 tensor
            np.testing.assert_array_equal(
                np.asarray(js.egress_fail(jnp.int32(tick), kj, shard)),
                ts.egress_fail(torch.tensor(tick, dtype=torch.int32), kt,
                               shard).numpy(),
                err_msg=f"egress_fail tick={tick} shard={shard}")
            for key in (0, 5, 77, -1):
                assert js.fails(tick, key, shard) == ts.fails(tick, key,
                                                              shard)
                assert (js.fails_egress(tick, key, shard)
                        == ts.fails_egress(tick, key, shard))
    spikes = dict(seed=kw["seed"], spike_prob=0.3, spike_us=50.0)
    assert [jfaults.Schedule(**spikes).spike(t) for t in range(100)] == \
        [tfaults.Schedule(**spikes).spike(t) for t in range(100)]
    assert not tfaults.NULL.active and not tfaults.NULL.egress_active
