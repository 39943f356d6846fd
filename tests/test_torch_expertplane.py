"""The port's expert plane against the JAX ``repro.core.expertplane``.

Each case builds the same config, seeded numpy expert slabs, router and
tokens in both packages and runs ``moe_decode`` step after step: the JAX
plane jitted (its ``gather_rows`` on its ``ref`` path, as off the TPU, or
the Pallas body in interpret mode), the port with its batch executor and,
on a clone, its reference executor.  After every step ``slot_of``,
``expert_of``, ``clock``, ``access``, ``step`` and the hot store must agree
bit for bit, in both executors; ``y`` within 1e-5 of the largest output in
f32 and within 1e-2 of it in bf16 (the expert products round to bf16 after
an f32 sum whose order differs between XLA and PyTorch: a few bf16 ulps).

The router's top-k decides which experts are fetched, so each step first
asserts that, for every token, the k-th and (k+1)-th router probabilities
stand apart by more than 1e-4 (relative): a rounding tie then fails as a
tie and not as a fault of the port.  The exact ties that ``lax.top_k``
resolves by lowest index (a zero token's uniform probabilities, the 0/1
missing mask, equal clocks) are built on purpose.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expertplane as jep
from repro.core import faults as jfaults
from repro_torch import convert
from repro_torch.core import expertplane as tep
from repro_torch.core import faults as tfaults

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
INTS = ("slot_of", "expert_of", "clock", "access", "step")
HOT = ("hot_wi", "hot_wg", "hot_wo")


def _cfgs(dt="f32", faults=None, kernel_impl="auto", **kw):
    jd, td, _ = DTYPES[dt]
    kw = dict(dict(n_experts=8, d_model=16, d_ff=32, hot_slots=4, topk=2,
                   fetch_budget=4), **kw)
    jc = jep.ExpertPlaneConfig(dtype=jd, kernel_impl=kernel_impl,
                               faults=None if faults is None
                               else jfaults.Schedule(**faults), **kw)
    tc = tep.ExpertPlaneConfig(dtype=td, faults=None if faults is None
                               else tfaults.Schedule(**faults), **kw)
    return jc, tc


def _weights(cfg, seed):
    rng = np.random.RandomState(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return (rng.randn(E, d, f).astype(np.float32) * 0.1,
            rng.randn(E, d, f).astype(np.float32) * 0.1,
            rng.randn(E, f, d).astype(np.float32) * 0.1,
            rng.randn(d, E).astype(np.float32))


def _as_jax(a, dt):
    return jnp.asarray(a).astype(dt)


def _as_port(a, dt):
    return torch.from_numpy(a).to(dt)


def _margin(x, router, k):
    """Smallest relative gap between a token's k-th and (k+1)-th router
    probability (the top-k decision)."""
    p = torch.softmax(x.float() @ router.float(), dim=-1)
    p = p.sort(dim=-1, descending=True).values
    return float(((p[:, k - 1] - p[:, k]) / p[:, k - 1]).min())


def assert_expert_states(js, ts, ctx=""):
    a = jax.device_get(js)._asdict()
    b = convert.expert_state_to_numpy(ts)
    for k in INTS + HOT:
        want = np.asarray(a[k])
        if k in HOT:
            want = want.astype(np.float32)
        else:
            assert want.dtype == b[k].dtype, (k, ctx)
        np.testing.assert_array_equal(want, b[k], err_msg=f"{k} {ctx}")


def assert_port_states_equal(a, b, ctx=""):
    for k in INTS + HOT:
        assert torch.equal(a.view(k), b.view(k)), f"{k} {ctx}"


def run(jc, tc, steps, tokens, seed=0, zero_rows=()):
    """Both packages through ``steps`` moe_decode steps of ``tokens``
    tokens each, compared after every step; the port's reference executor
    on a clone of its state.  Returns the port state."""
    jd, td, tol = DTYPES["f32" if tc.dtype == torch.float32 else "bf16"]
    wi, wg, wo, router = _weights(tc, seed)
    jw = [_as_jax(w, jd) for w in (wi, wg, wo)]
    tw = [_as_port(w, td) for w in (wi, wg, wo)]
    jrouter, trouter = jnp.asarray(router), torch.from_numpy(router)
    js = jep.init(jc)
    ts = tep.init(tc, "cpu")
    tr = ts.clone()
    step = jax.jit(partial(jep.moe_decode, jc))
    rng = np.random.RandomState(seed + 1)
    for i in range(steps):
        x = rng.randn(tokens, tc.d_model).astype(np.float32)
        for r in zero_rows:
            x[r] = 0.0
        tx = _as_port(x, td)
        live = [r for r in range(tokens) if r not in zero_rows]
        assert _margin(tx[live], trouter, tc.topk) > 1e-4, f"tie, step {i}"
        jy, js = step(js, jrouter, _as_jax(x, jd), *jw)
        ty, _ = tep.moe_decode(tc, ts, trouter, tx, *tw)
        ry, _ = tep.moe_decode(tc, tr, trouter, tx, *tw, mode="reference")
        jy = np.asarray(jy.astype(jnp.float32))
        err = np.abs(jy - ty.float().numpy()).max()
        assert err <= tol * max(np.abs(jy).max(), 1e-30), (i, err)
        assert torch.equal(ty, ry), f"batch vs reference y, step {i}"
        assert_expert_states(js, ts, f"step {i}")
        assert_port_states_equal(ts, tr, f"batch vs reference, step {i}")
    return ts


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sizes", [
    dict(),                                             # 8 experts, 4 slots
    dict(n_experts=32, hot_slots=6, topk=2, fetch_budget=3),
    dict(n_experts=24, hot_slots=8, topk=3, fetch_budget=8, capacity=2),
], ids=["e8s4", "e32s6", "e24s8-cap2"])
def test_moe_decode_matches_jax(sizes, dt):
    """Steady churn: more experts needed per step than slots or budget,
    so every step evicts; with ``capacity=2`` slots also drop tokens."""
    jc, tc = _cfgs(dt, **sizes)
    ts = run(jc, tc, steps=8, tokens=5)
    assert int((ts.view("slot_of") >= 0).sum()) == tc.hot_slots
    assert int(ts.access.sum()) > 0


def test_moe_decode_pallas_gather_matches():
    """The JAX plane's fetch through the Pallas ``gather_rows`` body in
    interpret mode, against the port."""
    jc, tc = _cfgs(kernel_impl="interpret", n_experts=16, hot_slots=4)
    run(jc, tc, steps=4, tokens=3)


def test_zero_token_and_equal_clocks_tie_like_lax_top_k():
    """A zero token routes uniformly: its top-k are the lowest expert ids;
    at ``init`` every clock is 0, so victims go in slot order."""
    jc, tc = _cfgs()
    ts = run(jc, tc, steps=3, tokens=4, zero_rows=(0, 2))
    assert int(ts.view("slot_of")[0]) >= 0 and int(ts.view("slot_of")[1]) >= 0


def test_plan_fetch_ties_match_jax():
    """More missing experts than the budget (the 0/1 mask is all ties),
    victims among equal clocks with needed experts pinned."""
    jc, tc = _cfgs(n_experts=16, hot_slots=6, fetch_budget=4)
    js, ts = jep.init(jc), tep.init(tc, "cpu")
    for needed_ids, clocks in [([1, 3, 5, 7, 9, 11], [0] * 6),
                               ([0, 15], [3, 1, 1, 3, 0, 1])]:
        needed = np.zeros(16, bool)
        needed[needed_ids] = True
        js = js._replace(slot_of=js.slot_of.at[jnp.asarray([2, 3, 4])].set(
            jnp.asarray([0, 1, 2])), expert_of=js.expert_of.at[:3].set(
            jnp.asarray([2, 3, 4])), clock=jnp.asarray(clocks, jnp.int32))
        ts = convert.expert_state_from_numpy(tc, jax.device_get(js), "cpu")
        jp = jep.plan_fetch(jc, js, jnp.asarray(needed))
        tp = tep.plan_fetch(tc, ts, torch.from_numpy(needed))
        np.testing.assert_array_equal(np.asarray(jp.expert), tp.expert.numpy())
        np.testing.assert_array_equal(np.asarray(jp.slot), tp.slot.numpy())


def test_fault_schedule_masks_fetches_like_jax():
    """Faulted fetches drop out of the plan: no slot claimed, the tokens
    re-normalized away; both executors and JAX agree."""
    faults = dict(seed=3, fail_prob=0.4)
    jc, tc = _cfgs(faults=faults, n_experts=16, hot_slots=4)
    ts = run(jc, tc, steps=6, tokens=4)
    jc0, tc0 = _cfgs(n_experts=16, hot_slots=4)
    clean = run(jc0, tc0, steps=6, tokens=4)
    assert not torch.equal(ts.view("slot_of"), clean.view("slot_of"))


def test_state_round_trips_through_numpy():
    jc, tc = _cfgs(dt="bf16")
    ts = run(jc, tc, steps=2, tokens=3)
    back = convert.expert_state_from_numpy(
        tc, convert.expert_state_to_numpy(ts), "cpu")
    assert_port_states_equal(ts, back)
    stacked = convert.expert_state_from_numpy(
        tc, convert.expert_state_to_numpy([ts, ts]), "cpu")
    assert len(stacked) == 2
    assert_port_states_equal(ts, stacked[1])


def test_fetch_budget_above_slots_raises():
    _, tc = _cfgs(hot_slots=2, fetch_budget=4)
    with pytest.raises(ValueError, match="fetch_budget"):
        tep.init(tc, "cpu")
