"""The serving engine's replay of its device calls from captured CUDA
graphs (``serving.engine``): the field discipline a capture relies on
(``in_place``, ``adopt``), which engines replay (``replays``), and, on a
card, the replaying engine held bit for bit against plain plane calls."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import batch as batch_lib
from repro_torch.core import faults
from repro_torch.core import plane as plane_lib
from repro_torch.core import state as state_lib
from repro_torch.core.layout import PlaneConfig
from repro_torch.kernels import ops
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.engine import Engine, EngineConfig

N_OBJS = 512
# a log of virtual pages that lasts the runs below (8x the data pages), and
# every local unpinned page a victim, so that evacuation moves rows
PLANE = dict(num_objs=N_OBJS, obj_dim=8, page_objs=8, num_frames=16,
             num_vpages=8 * (N_OBJS // 8), readahead=2,
             evac_garbage_threshold=-1.0)
DATA = np.random.RandomState(3).rand(N_OBJS, 8).astype(np.float32)
BATCH = 32
TICKS = 120
EVAC_EVERY, EPOCH_EVERY = 8, 16


def _ticks(n, seed=11):
    """``n`` batches of skewed ids (a hot set that drifts)."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(n):
        hot = rng.randint(0, N_OBJS, BATCH // 2) % 64 + 8 * (t // 20)
        out.append(np.concatenate([hot % N_OBJS, rng.randint(
            0, N_OBJS, BATCH - BATCH // 2)]).astype(np.int32))
    return out


def _access(pcfg, plane):
    """The engine's captured call: plan and execute, returning the rows."""
    if plane == "paging":
        return lambda s, ids: batch_lib.execute_paging_access(
            pcfg, s, ids, batch_lib.plan_access(pcfg, s, ids,
                                                split_by_psf=False))[1]
    return lambda s, ids: batch_lib.execute_access(
        pcfg, s, ids, batch_lib.plan_access(pcfg, s, ids))[1]


def _plain(pcfg, plane, s, ids):
    if plane == "paging":
        return batch_lib.paging_access(pcfg, s, ids)[1]
    return plane_lib.access(pcfg, s, ids)[1]


def _assert_states_equal(a, b, ctx=""):
    """Every field and counter equal, the trash rows aside: a masked
    scatter's duplicate writes land there in no fixed order on a card."""
    for k in state_lib.PlaneState._fields:
        if k == "stats":
            for kk in state_lib.PlaneStats._fields:
                assert torch.equal(getattr(a.stats, kk),
                                   getattr(b.stats, kk)), f"stats.{kk} {ctx}"
        else:
            assert torch.equal(a.view(k), b.view(k)), f"{k} {ctx}"


@pytest.mark.parametrize("plane", ["hybrid", "paging"])
def test_in_place_matches_plain_calls_and_keeps_every_tensor(plane):
    """``in_place`` over the engine's three calls, run eagerly, against the
    plain plane calls on a clone: the same rows, fields and counters bit
    for bit at every tick, while every field keeps its tensor."""
    pcfg = PlaneConfig(**PLANE)
    s = state_lib.create(pcfg, torch.from_numpy(DATA), device="cpu")
    ref = s.clone()
    held = engine_lib._tensors(s)
    stats = s.stats
    access = _access(pcfg, plane)
    evac = functools.partial(plane_lib.evacuate, pcfg)
    epoch = functools.partial(plane_lib.advance_epoch, pcfg)
    for t, ids in enumerate(_ticks(TICKS), start=1):
        ids = torch.from_numpy(ids)
        rows = engine_lib.in_place(access, s, ids)
        assert torch.equal(rows, _plain(pcfg, plane, ref, ids)), t
        if plane == "hybrid" and t % EVAC_EVERY == 0:
            engine_lib.in_place(evac, s)
            plane_lib.evacuate(pcfg, ref)
        if plane == "hybrid" and t % EPOCH_EVERY == 0:
            engine_lib.in_place(epoch, s)
            plane_lib.advance_epoch(pcfg, ref)
        _assert_states_equal(s, ref, f"at tick {t}")
        assert s.stats is stats
        assert all(a is b for a, b in zip(engine_lib._tensors(s), held)), t
    if plane == "hybrid":
        assert int(s.stats.evac_moved) > 0 and int(s.stats.epochs) > 0
        assert int(s.stats.obj_ins) > 0
    assert int(s.stats.page_ins) > 0


def test_adopt_takes_a_field_rebound_from_outside():
    """A field rebound between replays (a caller's own plane call, or a
    replaced counter object) is copied into the held tensor and bound to
    it; a rebound field of another shape is refused."""
    pcfg = PlaneConfig(**PLANE)
    s = state_lib.create(pcfg, torch.from_numpy(DATA), device="cpu")
    held = engine_lib._tensors(s)
    step = s.step
    engine_lib.adopt(s, held)
    plane_lib.access(pcfg, s, torch.arange(BATCH, dtype=torch.int32))
    assert s.step is not step                   # the plane rebinds it
    s.stats = state_lib.PlaneStats.zeros("cpu")
    s.stats.hits = torch.full((), 41, dtype=torch.int32)
    fresh = s.stats
    engine_lib.adopt(s, held)
    assert all(a is b for a, b in zip(engine_lib._tensors(s), held))
    assert s.step is step and int(s.step) == 1
    assert s.stats is fresh and int(s.stats.hits) == 41
    assert int(s.stats.misses) == 0
    s.step = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        engine_lib.adopt(s, held)
    assert s.step is not step


@pytest.mark.parametrize("rebind", [
    lambda s: setattr(s, "fill_vpage", s.evac_hot_vpage),
    lambda s: setattr(s, "epoch", s.stats.epochs),
    lambda s: (setattr(s, "step", s.step + 1),
               setattr(s, "lru_hand", s.step)),
    lambda s: setattr(s, "step", torch.zeros((), dtype=torch.int64)),
], ids=["field", "counter", "two-fields", "dtype"])
def test_in_place_refuses_aliased_or_reshaped_fields(rebind):
    """A call that rebinds a field to another field's tensor, gives two
    fields one tensor, or changes a field's dtype is refused, and the state
    holds its old tensors again."""
    pcfg = PlaneConfig(**PLANE)
    s = state_lib.create(pcfg, torch.from_numpy(DATA), device="cpu")
    held = engine_lib._tensors(s)
    with pytest.raises(ValueError):
        engine_lib.in_place(rebind, s)
    assert all(a is b for a, b in zip(engine_lib._tensors(s), held))


def test_add_launches_moves_every_count():
    """``ops.add_launches`` adds to each count ``launch_counts`` reads (the
    launches a replay makes) and takes them off again."""
    before = ops.launch_counts()
    delta = {k: i + 1 for i, k in enumerate(before)}
    ops.add_launches(delta)
    try:
        assert ops.launch_counts() == {k: n + delta[k]
                                       for k, n in before.items()}
    finally:
        ops.add_launches({k: -n for k, n in delta.items()})
    assert ops.launch_counts() == before


EAGER = {
    "object": dict(plane="object"),
    "shards": dict(shards=2),
    "faults": dict(faults=faults.Schedule(fail_prob=0.1)),
    "deadline": dict(deadline_us=1e6),
    "retries": dict(max_retries=2),
    "breaker": dict(breaker_threshold=0.5),
    "reference": dict(mode="reference"),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_eager_configurations_replay_nothing(name):
    """The engines that keep eager dispatch, judged as on a card; and the
    same engine on the CPU serves without building a graph."""
    cfg = EngineConfig(batch=BATCH, **EAGER[name])
    pcfg = PlaneConfig(**PLANE)
    assert not engine_lib.replays(cfg, pcfg, "cuda")
    assert engine_lib.replays(EngineConfig(batch=BATCH), pcfg, "cuda")
    eng = Engine(cfg, pcfg, DATA, device="cpu")
    for ids in _ticks(4):
        eng.submit(ids)
    eng.drain()
    assert eng._access_replay is None
    assert eng.replay_counts == dict(captures=0, replays=0, eager=0,
                                     failed=0)


@pytest.mark.parametrize("plane", ["hybrid", "paging"])
def test_cpu_and_group_engines_replay_nothing(plane):
    """On the CPU, or with a process group, no engine replays; on a card
    the hybrid and paging planes do."""
    pcfg = PlaneConfig(**PLANE)
    cfg = EngineConfig(plane=plane, batch=BATCH, evac_every=EVAC_EVERY,
                       epoch_every=EPOCH_EVERY)
    assert engine_lib.replays(cfg, pcfg, "cuda")
    assert not engine_lib.replays(cfg, pcfg, "cpu")
    assert not engine_lib.replays(cfg, pcfg, "cuda", group=object())
    eng = Engine(cfg, pcfg, DATA, device="cpu")
    for ids in _ticks(2 * EVAC_EVERY):
        eng.submit(ids)
    eng.drain()
    assert eng._access_replay is None
    if plane == "hybrid":
        assert not isinstance(eng._evac, engine_lib._Replay)
        assert not isinstance(eng._epoch, engine_lib._Replay)
    assert sum(eng.replay_counts.values()) == 0


# ---------------------------------------------------------------------------
# on a card: the replaying engine against plain plane calls
# ---------------------------------------------------------------------------

CARD_TICKS = 300
CARD_EVAC, CARD_EPOCH = 16, 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launched(fn, tally: dict):
    """``fn()``, adding the kernel launches it counts to ``tally``."""
    before = ops.launch_counts()
    out = fn()
    for k, n in ops.launch_counts().items():
        tally[k] = tally.get(k, 0) + n - before[k]
    return out


def _served(plane, dev, evac_budget=0):
    """A replaying engine over CARD_TICKS ticks (the last one short)
    beside plain plane calls on a clone of its state (the evacuation round,
    or with ``evac_budget`` its slices, and the epoch on the engine's
    ticks): the engine, the clone, both sides' rows, the rows of the first
    ticks as first read, the engine's rows of those ticks as they stand at
    the end, and each side's kernel launch counts."""
    pcfg = PlaneConfig(**PLANE)
    cfg = EngineConfig(plane=plane, batch=BATCH, evac_every=CARD_EVAC,
                       epoch_every=CARD_EPOCH if plane == "hybrid" else 0,
                       evac_budget=evac_budget)
    eng = Engine(cfg, pcfg, DATA, device=dev)
    ref = eng.state.clone()
    ticks = _ticks(CARD_TICKS, seed=5)
    ticks[-1] = ticks[-1][:BATCH - 7]
    got, want, early = [], [], []
    launches = {"engine": {}, "plain": {}}
    period = CARD_EVAC // -(-16 // max(evac_budget, 1))    # the engine's
    cleared = [0]           # the last round whose slice cleared the bits

    def plain(t, padded):
        rows = _plain(pcfg, plane, ref, padded)
        if plane == "hybrid" and evac_budget and t % period == 0:
            clear = t // CARD_EVAC > cleared[0]
            cleared[0] = max(cleared[0], t // CARD_EVAC)
            plane_lib.evacuate(pcfg, ref, max_pages=evac_budget,
                               clear_access=clear)
        elif plane == "hybrid" and not evac_budget and t % CARD_EVAC == 0:
            plane_lib.evacuate(pcfg, ref)
        if plane == "hybrid" and t % CARD_EPOCH == 0:
            plane_lib.advance_epoch(pcfg, ref)
        return rows

    for t, ids in enumerate(ticks, start=1):
        got.append(_launched(lambda: eng.submit(ids), launches["engine"]))
        padded = np.full((BATCH,), -1, np.int32)
        padded[:ids.size] = ids
        padded = torch.from_numpy(padded).to(dev)
        want.append(_launched(lambda: plain(t, padded),
                              launches["plain"])[:ids.size])
        if t <= 8:
            eng.drain()
            early.append(got[-1].clone())
    eng.drain()
    torch.cuda.synchronize()
    return eng, ref, got, want, early, launches


@pytest.fixture(scope="module")
def hybrid_served():
    return _served("hybrid", _card())


@pytest.mark.card
def test_card_hybrid_replay_matches_plain_calls(hybrid_served):
    eng, ref, got, want = hybrid_served[:4]
    for t, (a, b) in enumerate(zip(got, want), start=1):
        assert torch.equal(a, b), f"rows differ at tick {t}"
    assert got[-1].shape[0] == BATCH - 7
    _assert_states_equal(eng.state, ref)
    assert int(ref.stats.evac_moved) > 0 and int(ref.stats.epochs) > 0


@pytest.mark.card
def test_card_rows_of_early_ticks_stay(hybrid_served):
    """The rows ``submit`` returned are copies: later replays leave them."""
    got, early = hybrid_served[2], hybrid_served[4]
    for t, r in enumerate(early):
        assert torch.equal(got[t], r), f"rows of tick {t + 1} changed"


@pytest.mark.card
def test_card_captures_and_replays_are_counted(hybrid_served):
    """One capture a call (three in the benchmark's setting), after one
    eager run of each; every later call replays."""
    eng = hybrid_served[0]
    evacs, epochs = CARD_TICKS // CARD_EVAC, CARD_TICKS // CARD_EPOCH
    assert eng.replay_counts == dict(
        captures=3, eager=3, failed=0,
        replays=(CARD_TICKS - 1) + (evacs - 1) + (epochs - 1))


@pytest.mark.card
def test_card_replays_count_their_launches(hybrid_served):
    """The kernel launch counts of the replaying engine are those of the
    plain calls: each replay adds the launches its graph makes, and a
    capture adds none."""
    launches = hybrid_served[5]
    assert launches["engine"] == launches["plain"]
    assert launches["engine"]["gather_rows"] >= CARD_TICKS


@pytest.mark.card
def test_card_sliced_evacuation_replay_matches_plain_calls():
    """With an evacuation budget the engine replays its two slice calls
    (the one that clears the access bits opens each round): rows, state
    and launch counts as the plain slice calls give them."""
    budget = 4
    eng, ref, got, want, _, launches = _served("hybrid", _card(),
                                               evac_budget=budget)
    for t, (a, b) in enumerate(zip(got, want), start=1):
        assert torch.equal(a, b), f"rows differ at tick {t}"
    _assert_states_equal(eng.state, ref)
    assert int(ref.stats.evac_moved) > 0
    assert launches["engine"] == launches["plain"]
    period = CARD_EVAC // -(-16 // budget)
    rounds = CARD_TICKS // CARD_EVAC
    slices = CARD_TICKS // period - rounds
    epochs = CARD_TICKS // CARD_EPOCH
    assert eng.replay_counts == dict(
        captures=4, eager=4, failed=0,
        replays=(CARD_TICKS - 1) + (rounds - 1) + (slices - 1)
        + (epochs - 1))


@pytest.mark.card
def test_card_paging_replay_matches_plain_calls():
    eng, ref, got, want, _, launches = _served("paging", _card())
    for t, (a, b) in enumerate(zip(got, want), start=1):
        assert torch.equal(a, b), f"rows differ at tick {t}"
    _assert_states_equal(eng.state, ref)
    assert int(ref.stats.page_ins) > 0
    assert launches["engine"] == launches["plain"]
    assert eng.replay_counts == dict(captures=1, eager=1, failed=0,
                                     replays=CARD_TICKS - 1)


@pytest.mark.card
def test_card_adopts_a_field_rebound_between_ticks():
    """A plain plane call on the engine's state between two replays (as
    the benchmark's fill makes before its first tick) is adopted, and a
    state replaced whole is captured anew."""
    dev = _card()
    pcfg = PlaneConfig(**PLANE)
    eng = Engine(EngineConfig(batch=BATCH), pcfg, DATA, device=dev)
    ref = eng.state.clone()
    ticks = [torch.from_numpy(x).to(dev) for x in _ticks(8, seed=2)]
    for ids in ticks[:3]:
        assert torch.equal(eng.serve_batch(ids),
                           _plain(pcfg, "hybrid", ref, ids))
    for s in (eng.state, ref):
        plane_lib.access(pcfg, s, ticks[3])
    for ids in ticks[4:6]:
        assert torch.equal(eng.serve_batch(ids),
                           _plain(pcfg, "hybrid", ref, ids))
    _assert_states_equal(eng.state, ref)
    eng.state = eng.state.clone()
    for ids in ticks[6:]:
        assert torch.equal(eng.serve_batch(ids),
                           _plain(pcfg, "hybrid", ref, ids))
    _assert_states_equal(eng.state, ref)
    assert eng.replay_counts["captures"] == 2
    assert eng.replay_counts["replays"] == 6


@pytest.mark.card
def test_card_a_capture_that_raises_stays_eager():
    """A call that reads the host cannot be captured: it is counted and
    runs eagerly from then on, with the same results."""
    dev = _card()
    pcfg = PlaneConfig(**PLANE)
    s = state_lib.create(pcfg, torch.from_numpy(DATA), device=dev)
    ref = s.clone()
    counts = dict.fromkeys(("captures", "replays", "eager", "failed"), 0)

    def step(st, ids):
        st.step = st.step + int(st.step) * 0      # a host read
        return plane_lib.access(pcfg, st, ids)[1]
    call = engine_lib._Replay(step, "engine.execute.replay", counts)
    for ids in _ticks(4, seed=4):
        ids = torch.from_numpy(ids).to(dev)
        assert torch.equal(call(s, ids), _plain(pcfg, "hybrid", ref, ids))
    _assert_states_equal(s, ref)
    assert counts == dict(captures=0, replays=0, eager=4, failed=1)
