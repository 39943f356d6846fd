"""The decode step's replay from one captured CUDA graph
(``models/replay.py``, ``api.decode_step``): the rule that decides when a
step may replay, the write-back of the plane fields a captured step
rebinds, the eager step on the CPU, and, on a card, the replayed step held
bit for bit against the eager one."""
import dataclasses
import functools

import pytest
import torch

from repro_torch import configs
from repro_torch.core import batch as batch_lib
from repro_torch.core import kvplane, paths
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, common, replay
from repro_torch.models import lm as lm_lib
from repro_torch.models import mlp as mlp_lib

# the decode kit's CPU size (bench/lm_dense.py): Yi's smoke widths, one
# sequence of 1,920 tokens of context in 64-token pages of a 4,096-token
# sparse plane, the top 4 pages selected, 6 frames, 2 fetched a step
PLANE = {"SPARSE_TOPK": 4, "SPARSE_LOCAL_FRAMES": 6, "FETCH_BUDGET": 2}
CAPACITY, CONTEXT = 4096, 1920

# one function of each module the step reaches
REACHED = [(api, "_attn_qkv"), (common, "rope"), (mlp_lib, "mlp"),
           (lm_lib, "embed_tokens"), (kvplane, "_select"),
           (batch_lib, "stable_order"), (paths, "put"),
           (ops, "page_scores")]
IDS = [f"{m.__name__.rsplit('.', 1)[1]}.{n}" for m, n in REACHED]


def _plain(orig):
    """A wrapper that does not declare its original (a recorder, a fault)."""
    def inner(*a, **kw):
        return orig(*a, **kw)
    return inner


def _declared(orig):
    """A wrapper that declares its original (a span, ``functools.wraps``)."""
    @functools.wraps(orig)
    def inner(*a, **kw):
        return orig(*a, **kw)
    return inner


def _setup(monkeypatch, device, seed=0):
    """The smoke model through its sparse plane, each layer's far tier
    holding CONTEXT seeded tokens with their page summaries: config,
    shape, params, state, a first token."""
    for k, v in PLANE.items():
        monkeypatch.setattr(api, k, v)
    cfg = dataclasses.replace(configs.get_smoke("yi-9b"),
                              dtype=torch.bfloat16)
    shape = configs.ShapeConfig("long", CAPACITY, 1, "decode_long")
    params = api.init_params(cfg, seed, device)
    state = api.init_decode_state(cfg, shape, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    n = CONTEXT // api.PAGE_TOKENS
    for (s,) in state.kv:
        KVH, _, P, Dh = s.k_slab.shape
        k = (0.1 * torch.randn((KVH, n, P, Dh), generator=g, device=device)
             ).to(s.k_slab.dtype)
        s.k_slab[:, :n] = k
        s.v_slab[:, :n] = torch.randn((KVH, n, P, Dh), generator=g,
                                      device=device).to(s.v_slab.dtype)
        s.kmax[:, :n] = k.amax(dim=2).float()
        s.kmin[:, :n] = k.amin(dim=2).float()
    state.lengths.fill_(CONTEXT)
    tok = torch.randint(0, cfg.vocab, (1,), generator=g, device=device,
                        dtype=torch.int32)
    return cfg, shape, params, state, tok


def _planes_equal(kvc, a, b, ctx=""):
    """Every plane field equal, the trash rows aside: a masked scatter's
    duplicate writes land there in no fixed order on a card."""
    for (x,), (y,) in zip(a.kv, b.kv):
        for k in x._fields:
            assert torch.equal(x.view(kvc, k), y.view(kvc, k)), f"{k} {ctx}"


# ---------------------------------------------------------------------------
# the rule: when a step may replay
# ---------------------------------------------------------------------------

def test_the_step_modules_are_those_it_reaches():
    assert {m.__name__ for m in api.STEP_MODULES} == {
        f"repro_torch.{n}" for n in (
            "models.api", "models.common", "models.mlp", "models.lm",
            "core.kvplane", "core.batch", "core.paths", "kernels.ops")}
    fns = api._STEP_FUNCTIONS
    for m, n in REACHED:
        assert (m, n, getattr(m, n)) in fns
    assert replay.as_imported(fns)


@pytest.mark.parametrize("module, name", REACHED, ids=IDS)
def test_a_replaced_function_keeps_the_step_eager(monkeypatch, module, name):
    fns = api._STEP_FUNCTIONS
    assert replay.may_replay("cuda", fns)
    monkeypatch.setattr(module, name, _plain(getattr(module, name)))
    assert not replay.as_imported(fns)
    assert not replay.may_replay("cuda", fns)


@pytest.mark.parametrize("module, name", REACHED, ids=IDS)
def test_a_declared_wrapper_counts_as_its_original(monkeypatch, module,
                                                    name):
    """A span's wrapper (``functools.wraps``), even two deep, keeps the
    step replaying; a plain wrapper around a declared one does not."""
    fns = api._STEP_FUNCTIONS
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, _declared(_declared(orig)))
    assert replay.may_replay("cuda", fns)
    monkeypatch.setattr(module, name, _plain(_declared(orig)))
    assert not replay.may_replay("cuda", fns)


def test_restoring_the_original_allows_replay_again(monkeypatch):
    fns = api._STEP_FUNCTIONS
    with monkeypatch.context() as m:
        m.setattr(kvplane, "fetch_pages", _plain(kvplane.fetch_pages))
        assert not replay.may_replay("cuda", fns)
    assert replay.may_replay("cuda", fns)


def test_a_function_bound_by_name_in_another_module_counts(monkeypatch):
    """``kvplane.stable_order`` is ``core.batch``'s function bound in the
    KV plane's module: replacing it there changes the step too."""
    fns = api._STEP_FUNCTIONS
    monkeypatch.setattr(kvplane, "stable_order",
                        _plain(batch_lib.stable_order))
    assert batch_lib.stable_order is not kvplane.stable_order
    assert not replay.may_replay("cuda", fns)


def test_the_cpu_meta_tensors_and_a_mesh_never_replay(monkeypatch):
    fns = api._STEP_FUNCTIONS
    assert replay.may_replay(torch.device("cuda", 0), fns)
    assert not replay.may_replay("cpu", fns)
    assert not replay.may_replay("meta", fns)
    monkeypatch.setattr(mesh_lib, "_CURRENT", [object()])
    assert not replay.may_replay("cuda", fns)


@pytest.mark.parametrize("arch, kind, wrapped", [
    ("yi-9b", "decode_long", True), ("llama3-8b", "decode", True),
    ("mixtral-8x7b", "decode", True),          # the dropping MoE
    ("kimi-k2-1t-a32b", "decode", False),      # the expert plane
    ("xlstm-350m", "decode", False), ("zamba2-1.2b", "decode", False),
    ("seamless-m4t-medium", "decode", False)])
def test_which_steps_may_replay(arch, kind, wrapped):
    """The decoder-only families without the expert plane get a replayed
    step; the expert plane's and the ssm, hybrid and encdec steps stay
    plain functions."""
    step = api.decode_step(configs.get_smoke(arch),
                           configs.ShapeConfig("t", 4096, 1, kind))
    assert isinstance(step, replay.Replayed) == wrapped


# ---------------------------------------------------------------------------
# the plane fields a captured step rebinds
# ---------------------------------------------------------------------------

def _plane():
    return kvplane.init(kvplane.KVPlaneConfig(
        kv_heads=2, head_dim=8, page_tokens=4, num_pages=4, num_frames=4,
        batch=1, dtype=torch.float32), "cpu")


def test_written_back_keeps_every_plane_tensor():
    s = _plane()
    held = [getattr(s, k) for k in s._fields]

    def fn(x):
        s.step = s.step + x
        s.clock[0] = 3
        return "out"
    assert replay.written_back(fn, [s], 2) == "out"
    assert all(getattr(s, k) is h for k, h in zip(s._fields, held))
    assert int(s.step) == 2 and int(s.clock[0]) == 3


@pytest.mark.parametrize("rebind", [
    lambda s: torch.zeros((2,), dtype=torch.int32),      # another shape
    lambda s: s.step.float(),                            # another dtype
    lambda s: s.clock[:1].view(()),                      # another field's
])
def test_written_back_refuses_reshaped_or_aliased_fields(rebind):
    s = _plane()
    held = [getattr(s, k) for k in s._fields]

    def fn():
        s.step = rebind(s)
    with pytest.raises(ValueError):
        replay.written_back(fn, [s])
    assert all(getattr(s, k) is h for k, h in zip(s._fields, held))


def test_adopt_takes_a_field_rebound_since():
    s = _plane()
    held = [[getattr(s, k) for k in s._fields]]
    s.step = s.step + 5
    replay.adopt([s], held)
    assert s.step is held[0][-1] and int(s.step) == 5
    s.step = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        replay.adopt([s], held)


# ---------------------------------------------------------------------------
# the step on the CPU: eager, as it was
# ---------------------------------------------------------------------------

def test_the_cpu_step_is_eager_and_unchanged(monkeypatch):
    """At the decode kit's smoke size the step is the eager step: the same
    logits and plane state, bit for bit, on every step, trash rows too,
    and nothing captured."""
    cfg, shape, params, state, tok = _setup(monkeypatch, "cpu")
    step = api.decode_step(cfg, shape)
    ref = state.clone()
    for i in range(6):
        state, logits = step(params, state, tok)
        ref, want = step.fn(params, ref, tok)
        assert torch.equal(logits, want), i
        assert torch.equal(state.lengths, ref.lengths)
        for (x,), (y,) in zip(state.kv, ref.kv):
            for k in x._fields:
                assert torch.equal(getattr(x, k), getattr(y, k)), (i, k)
        tok = logits[:, :cfg.vocab].argmax(dim=-1)
    assert int(state.lengths[0]) == CONTEXT + 6
    assert all(int((s.frame_page[:-1] >= 0).sum()) > 0 for (s,) in state.kv)
    assert step.replay_counts == dict(captures=0, replays=0, eager=6,
                                      failed=0)


# ---------------------------------------------------------------------------
# on a card: the replayed step against the eager one
# ---------------------------------------------------------------------------

CARD_STEPS = 12
PLAIN_AT = 6        # the step run under a plain wrapper, eagerly


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launched(tally: dict, fn, *args):
    """``fn(*args)``, adding the kernel launches it counts to ``tally``."""
    before = ops.launch_counts()
    out = fn(*args)
    for k, n in ops.launch_counts().items():
        tally[k] = tally.get(k, 0) + n - before[k]
    return out


@pytest.mark.card
def test_card_replay_matches_the_eager_step(monkeypatch):
    """CARD_STEPS greedy steps of the replayed step beside the eager step
    on a clone of its state: logits, lengths and every plane field bit for
    bit at each step.  Step PLAIN_AT runs under a plain wrapper of
    ``kvplane._select``, eagerly, and the next one replays again with the
    planes' rebound ``step`` adopted; a call on other planes runs eagerly
    and keeps the graph.  One capture, no failure, and the kernel launch
    counts of the plain calls."""
    dev = _card()
    cfg, shape, params, state, tok = _setup(monkeypatch, dev, seed=3)
    kvc, _ = api.kv_plan(cfg, shape)
    step = api.decode_step(cfg, shape)
    ref = state.clone()
    launches = {"step": {}, "eager": {}}
    buffers = set()
    for i in range(CARD_STEPS):
        if i == PLAIN_AT:
            with monkeypatch.context() as m:
                m.setattr(kvplane, "_select", _plain(kvplane._select))
                state, logits = _launched(launches["step"], step, params,
                                          state, tok)
            assert state.kv[0][0].step is not step.held[0][-1]
        else:
            state, logits = _launched(launches["step"], step, params, state,
                                      tok)
            if i > 0:
                assert state.kv[0][0].step is step.held[0][-1]
                buffers.add(logits.data_ptr())
        ref, want = _launched(launches["eager"], step.fn, params, ref, tok)
        assert torch.equal(logits, want), f"logits at step {i}"
        assert torch.equal(state.lengths, ref.lengths), i
        _planes_equal(kvc, state, ref, f"at step {i}")
        tok = logits[:, :cfg.vocab].argmax(dim=-1)
    assert len(buffers) == 1                    # the graph's own logits
    assert step.replay_counts == dict(captures=1, replays=CARD_STEPS - 2,
                                      eager=2, failed=0)
    assert launches["step"] == launches["eager"]
    assert launches["step"]["page_scores"] == CARD_STEPS * cfg.n_layers
    other = ref.clone()
    other, got = step(params, other, tok)
    ref, want = step.fn(params, ref, tok)
    assert torch.equal(got, want)
    state, logits = step(params, state, tok)
    assert torch.equal(logits, want)
    _planes_equal(kvc, state, ref, "after a call on other planes")
    assert step.replay_counts == dict(captures=1, replays=CARD_STEPS - 1,
                                      eager=3, failed=0)


@pytest.mark.card
def test_card_a_capture_that_raises_stays_eager(monkeypatch):
    """A step that reads the host (inside a declared wrapper, so that the
    rule lets it be captured) cannot be captured: the failure is counted
    and the step runs eagerly from then on, with the eager step's
    results."""
    dev = _card()
    cfg, shape, params, state, tok = _setup(monkeypatch, dev, seed=4)
    kvc, _ = api.kv_plan(cfg, shape)
    orig = kvplane._select

    @functools.wraps(orig)
    def host_read(cfg_, s, q, n_valid, newest):
        int(n_valid[0])
        return orig(cfg_, s, q, n_valid, newest)
    monkeypatch.setattr(kvplane, "_select", host_read)
    step = api.decode_step(cfg, shape)
    ref = state.clone()
    for i in range(4):
        state, logits = step(params, state, tok)
        ref, want = step.fn(params, ref, tok)
        assert torch.equal(logits, want), i
        _planes_equal(kvc, state, ref, f"at step {i}")
        tok = logits[:, :cfg.vocab].argmax(dim=-1)
    assert step.replay_counts == dict(captures=0, replays=0, eager=4,
                                      failed=1)
