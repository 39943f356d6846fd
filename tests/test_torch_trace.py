"""The port's spans on the serving path (``repro_torch.core.trace``): the
gate, the tree an engine's ticks leave in ``torch.profiler``'s trace, and
that tracing changes no row and no counter."""
import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from repro_torch import convert
from repro_torch.core import trace
from repro_torch.core.layout import PlaneConfig
from repro_torch.serving.engine import Engine, EngineConfig

N_OBJS = 256
# every local page with a row is a victim, so that evacuation moves rows
PLANE = dict(num_objs=N_OBJS, obj_dim=8, page_objs=8, num_frames=12,
             num_vpages=3 * (N_OBJS // 8), evac_garbage_threshold=-1.0)
DATA = np.random.RandomState(0).rand(N_OBJS, 8).astype(np.float32)
ENGINE = dict(plane="hybrid", batch=16, dispatch="pipelined", evac_every=4,
              epoch_every=2)
TICKS = 12
EVAC_PAGES = 16                 # victims a foreground round

# each span of the tree and the span it runs inside
PARENT = {
    "engine.admit": "engine.submit",
    "engine.plan": "engine.submit",
    "engine.plan.classify": "engine.plan",
    "engine.plan.paging": "engine.plan",
    "engine.plan.runtime": "engine.plan",
    "engine.execute": "engine.submit",
    "engine.execute.begin": "engine.execute",
    "engine.execute.paging": "engine.execute",
    "engine.execute.runtime": "engine.execute",
    "engine.execute.profile": "engine.execute",
    "engine.execute.gather": "engine.execute",
    "engine.evacuate": "engine.submit",
    "engine.evacuate.plan": "engine.evacuate",
    "engine.evacuate.page": "engine.evacuate",
    "engine.epoch": "engine.submit",
    "engine.retire": "engine.submit",
    "engine.wait": "engine.retire",
}


def _workload():
    rng = np.random.RandomState(7)
    return [rng.randint(0, N_OBJS, 16).astype(np.int32)
            for _ in range(TICKS)]


def _engine():
    return Engine(EngineConfig(**ENGINE), PlaneConfig(**PLANE), DATA,
                  device="cpu")


def _submit(eng, batches):
    return [eng.submit(ids) for ids in batches]


def _rows(eng, rows):
    eng.drain()
    return [r.clone() for r in rows]


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A pipelined hybrid engine's submits under the profiler (the drain
    after it): its rows, the ``engine.*`` spans ``(name, start, end)`` of
    the trace and the batches left in flight when the profiler stopped."""
    eng = _engine()
    prof = _cpu_profile()
    prof.start()
    try:
        rows = _submit(eng, _workload())
    finally:
        prof.stop()
    left = len(eng._inflight)           # retired by the drain, untraced
    rows = _rows(eng, rows)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("engine.")]
    return eng, rows, spans, left


def test_profiler_flag_follows_the_profiler():
    """The gate is the flag ``torch.profiler.profile.start`` sets."""
    assert not autograd_profiler._is_profiler_enabled
    prof = _cpu_profile()
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled


def test_span_is_the_shared_noop_while_nothing_records():
    assert trace.span("engine.plan") is trace.OFF
    assert trace.span("engine.retire", 12) is trace.OFF
    with trace.span("engine.submit", 3) as got:
        assert got is None
    prof = _cpu_profile()
    prof.start()
    try:
        assert trace.span("engine.plan", 3) is not trace.OFF
    finally:
        prof.stop()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_every_span_sits_inside_its_parent(traced, name):
    _, _, spans, _ = traced
    mine = [(s, e) for n, s, e in spans if n == name]
    parents = [(s, e) for n, s, e in spans if n == PARENT[name]]
    assert mine, f"no {name} span"
    for s, e in mine:
        assert any(ps <= s and e <= pe for ps, pe in parents), (name, s, e)


def test_the_runtime_phase_sits_inside_execute_inside_submit(traced):
    _, _, spans, _ = traced

    def holders(name, s, e):
        return [(n, ps, pe) for n, ps, pe in spans
                if n == name and ps <= s and e <= pe]
    runtime = [(s, e) for n, s, e in spans if n == "engine.execute.runtime"]
    assert len(runtime) == TICKS
    for s, e in runtime:
        (_, xs, xe), = holders("engine.execute", s, e)
        assert len(holders("engine.submit", xs, xe)) == 1


def test_a_tick_has_one_submit_plan_and_execute(traced):
    _, _, spans, left = traced
    count = {n: sum(1 for m, _, _ in spans if m == n) for n in PARENT}
    submits = sum(1 for n, _, _ in spans if n == "engine.submit")
    assert submits == TICKS
    for name in ("engine.admit", "engine.plan", "engine.plan.classify",
                 "engine.plan.runtime", "engine.execute"):
        assert count[name] == TICKS, name
    assert count["engine.plan.paging"] == 2 * TICKS
    assert count["engine.epoch"] == TICKS // ENGINE["epoch_every"]
    assert count["engine.retire"] == count["engine.wait"] == TICKS - left


def test_an_evacuation_round_has_sixteen_pages(traced):
    _, _, spans, _ = traced
    rounds = [(s, e) for n, s, e in spans if n == "engine.evacuate"]
    assert len(rounds) == TICKS // ENGINE["evac_every"]
    for s, e in rounds:
        inside = [n for n, ps, pe in spans if s <= ps and pe <= e]
        assert inside.count("engine.evacuate.page") == EVAC_PAGES
        assert inside.count("engine.evacuate.plan") == 1


def test_tracing_changes_no_row_and_no_counter(traced):
    """The same ticks with the profiler off: every row, every
    ``PlaneStats`` field and the whole plane state equal."""
    eng_on, rows_on, _, _ = traced
    eng_off = _engine()
    rows_off = _rows(eng_off, _submit(eng_off, _workload()))
    for a, b in zip(rows_on, rows_off):
        assert torch.equal(a, b)
    on, off = eng_on.state.stats._asdict(), eng_off.state.stats._asdict()
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k
    a, b = (convert.state_to_numpy(e.state) for e in (eng_on, eng_off))
    for k in a:
        if k != "stats":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert eng_on.state.stats.evac_pages.item() > 0
    assert eng_on.state.stats.epochs.item() == TICKS // ENGINE["epoch_every"]
