"""The port's serving engine and launcher against the JAX engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.layout import PlaneConfig as JConfig
from repro.data import kvworkload as jworkload
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.core import plane as tplane
from repro_torch.core.layout import PlaneConfig
from repro_torch.data import kvworkload
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine, EngineConfig

N_OBJS = 256
PLANE = dict(num_objs=N_OBJS, obj_dim=8, page_objs=8, num_frames=12,
             num_vpages=3 * (N_OBJS // 8))
DATA = np.random.RandomState(0).rand(N_OBJS, 8).astype(np.float32)


def engines(dispatch="sync", plane_kw=None, **ekw):
    kw = dict(PLANE, **(plane_kw or {}))
    je = JEngine(JEngineConfig(batch=16, dispatch="sync", **ekw),
                 JConfig(kernel_impl="ref", **kw), jnp.asarray(DATA))
    te = Engine(EngineConfig(batch=16, dispatch=dispatch, **ekw),
                PlaneConfig(**kw), DATA, device="cpu")
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


@pytest.mark.parametrize("ekw", [
    dict(),
    dict(evac_budget=2, evac_every=4,
         plane_kw=dict(evac_garbage_threshold=-1.0)),   # background slices
    dict(epoch_every=4),                                # epoch governor
    dict(epoch_every=50, epoch_watermark_bytes=2048),   # byte watermark
], ids=["plain", "evac-slices", "epochs", "watermark"])
def test_engine_matches_jax_engine(ekw):
    """Same workload through both sync engines: the same served rows (the
    ground truth), the same counters and the same final plane state."""
    je, te = engines(**ekw)
    wl = list(kvworkload.zipf_churn(N_OBJS, 16, 40, seed=9))
    for ids, jids in zip(wl, jworkload.zipf_churn(N_OBJS, 16, 40, seed=9)):
        np.testing.assert_array_equal(ids, jids)
        rows = te.serve_batch(ids).numpy()
        np.testing.assert_array_equal(rows, np.asarray(je.serve_batch(ids)))
        np.testing.assert_array_equal(rows, DATA[ids])
    assert_same_state(je.state, te.state, str(ekw))
    assert te.latency.summary()["n"] == 40 * 16
    assert all(tplane.check_invariants(te.pcfg, te.state).values())
    stats = te.run(iter([]))["stats"]
    if "evac_budget" in ekw:
        assert stats["evac_pages"] > 0
    if "epoch_every" in ekw:
        assert stats["epochs"] > 0


@pytest.mark.parametrize("ekw", [dict(), dict(evac_budget=4, evac_every=8),
                                 dict(epoch_every=3)])
def test_pipelined_matches_sync(ekw):
    """The pipelined engine keeps batches in flight; its rows and final
    state must equal the sync engine's."""
    data = DATA
    eng_p = Engine(EngineConfig(batch=16, dispatch="pipelined", **ekw),
                   PlaneConfig(**PLANE), data, device="cpu")
    eng_s = Engine(EngineConfig(batch=16, dispatch="sync", **ekw),
                   PlaneConfig(**PLANE), data, device="cpu")
    batches = list(kvworkload.zipf_churn(N_OBJS, 16, steps=25, seed=4))
    futs = [eng_p.submit(ids) for ids in batches]
    eng_p.drain()
    for i, ids in enumerate(batches):
        rs = eng_s.serve_batch(ids).numpy()
        np.testing.assert_array_equal(futs[i].numpy(), rs, err_msg=str(i))
        np.testing.assert_array_equal(rs, data[ids])
    a, b = (convert.state_to_numpy(eng_p.state),
            convert.state_to_numpy(eng_s.state))
    for k in a:
        if k != "stats":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert eng_p.latency.summary()["n"] == sum(len(b) for b in batches)


def test_short_batches_pad_and_run_reports():
    _, te = engines()
    rows = te.serve_batch(np.array([5, 9, 200], np.int32))
    np.testing.assert_array_equal(rows.numpy(), DATA[[5, 9, 200]])
    rep = te.run(kvworkload.scan(N_OBJS, 16, steps=10))
    assert rep["stats"]["hits"] + rep["stats"]["misses"] == 3 + 160
    assert 0.0 <= rep["paging_fraction"] <= 1.0
    assert rep["latency"]["n"] == 163


def test_launcher_recipe_and_cpu_run(capsys):
    """``kv_plane_config`` is the JAX launcher's recipe
    (``repro.launch.serve.serve_kv``), and the launcher serves on the CPU
    when asked to, in both modes."""
    for objects, local in [(1000, 0.25), (8_388_608, 0.25), (64, 0.5)]:
        dp = -(-objects // 8)
        want = JConfig(num_objs=objects, obj_dim=32, page_objs=8,
                       num_frames=max(int(dp * local), 8),
                       num_vpages=3 * dp, readahead=2)
        got = serve.kv_plane_config(objects, local)
        for k in ("num_objs", "obj_dim", "page_objs", "num_frames",
                  "num_vpages", "readahead", "prefetch", "prefetch_budget",
                  "car_threshold", "evac_garbage_threshold", "car_decay"):
            assert getattr(got, k) == getattr(want, k), k
    serve.main(["--objects", "512", "--steps", "4", "--batch", "16",
                "--device", "cpu"])
    assert "plane=hybrid" in capsys.readouterr().out
    serve.main(["--mode", "lm", "--device", "cpu", "--tokens", "2",
                "--batch", "2"])
    assert "[serve:lm] arch=llama3-8b batch=2 decoded 2 tokens" in \
        capsys.readouterr().out


def test_oversized_batch_and_wrong_data_shape_raise():
    _, te = engines()
    with pytest.raises(ValueError, match="batch of 17"):
        te.submit(np.zeros(17, np.int32))
    with pytest.raises(ValueError, match="shape"):
        Engine(EngineConfig(batch=16), PlaneConfig(**PLANE), DATA[:10],
               device="cpu")
