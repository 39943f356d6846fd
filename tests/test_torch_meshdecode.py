"""The serve step on a model mesh (``models.api.decode_step`` under
``launch.mesh.use_mesh``: parameters as DTensors, the serve state laid
out by ``api.serve_state_on_mesh``, one local plane a rank) against the
port's plain decode step, on four gloo ranks as a 2 x 2 ``("data",
"model")`` mesh.

The plain step is itself held to JAX's ``decode_step`` by
``tests/test_torch_models.py``; JAX's own step on a mesh fails on jax 0.9.0
(``src/repro/launch/mesh.py:158``), so it cannot be the reference here.
Every rank draws the same smoke parameters and seeded serve state (f32),
runs ``STEPS`` greedy steps of the plain step on a clone and the same
steps on the mesh, and holds each step's logits within 1e-5 of the
largest; then the mesh state gathered whole (``api.serve_state_whole``)
against the plain one in JAX's logical views: every int and bool field
bit for bit, the float fields within 1e-5 of the largest.  The cases:

* llama3-8b: dense decode (4 sequences, 2 a dp rank), and decode_long
  through the sparse plane at ``shards = 2``, each dp rank its own shard;
* kimi-k2 through the expert plane (the experts split over "model" in its
  smoke config's d_ff, so the fetch exchanges rows);
* mixtral-8x7b's window plane (decode_long, one sequence, replicated),
  zamba2-1.2b's decode_long (Mamba2 and sparse shared attention),
  xlstm-350m, seamless-m4t-medium (cross attention).

The same file holds the CPU checks of the local planes themselves
(``kvplane.local_plane``/``concat_planes``, ``expertplane``'s, and an
expert plane's chunk through a step on a fake mesh).  A rank
whose check fails exits non-zero; the parent then kills the others and
fails.  Each spawn has a hard limit of 120 s.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import expertplane, kvplane

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
WORLD = 4
TOL = 1e-5
STEPS = 3
# arch:kind:seq_len:batch:prefix
CASES = {"llama": ["llama3-8b:decode:128:4:3,40,64,100",
                   "llama3-8b:decode_long:16384:1:8500",
                   "kimi-k2-1t-a32b:decode:128:4:3,40,64,100"],
         "families": ["mixtral-8x7b:decode_long:4096:1:60",
                      "zamba2-1.2b:decode_long:16384:1:8500",
                      "xlstm-350m:decode:64:4:0",
                      "seamless-m4t-medium:decode:128:4:3,40,64,100"]}


def spawn(tmp_path: Path, cases: list) -> list:
    """Run this file as WORLD ranks over ``cases``; returns each rank's
    output.  Fails (after killing every rank) when a rank fails or the
    spawn outlives SPAWN_TIMEOUT_S."""
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    logs = [tmp_path / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r in range(WORLD):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), init, *cases],
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
                pytest.fail(f"{WORLD}-rank spawn: {why}\n{tail}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [log.read_text() for log in logs]


@pytest.mark.parametrize("group", sorted(CASES))
def test_mesh_decode_equals_plain_decode(tmp_path, group):
    outs = spawn(tmp_path, CASES[group])
    for r, out in enumerate(outs):
        for case in CASES[group]:
            assert f"rank {r}: {case} ok" in out, out[-2000:]


# --------------------------------------------------------------------------
# the local planes, in one process
# --------------------------------------------------------------------------

def _same(a, b, fields):
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_dense_planes_concatenate_to_the_plain_plane(n):
    """A dense plane split over n dp ranks: each rank's plane is, at init,
    ``kvplane.init`` of its B/n sequences, trash rows included; after
    seeded appends and attends on the whole plane, the ranks' planes joined
    in dp order (``concat_planes``) give the plain plane's logical views
    bit for bit, and each rank's plane steps as its slice of the whole."""
    cfg = kvplane.KVPlaneConfig(kv_heads=2, head_dim=8, page_tokens=4,
                                num_pages=3, num_frames=8 * 3, batch=8,
                                dtype=torch.float32)
    lc = kvplane.local_config(cfg, n)
    whole = kvplane.init(cfg, "cpu")
    for r in range(n):
        _same(kvplane.local_plane(cfg, whole, r, n), kvplane.init(lc, "cpu"),
              kvplane.KVPlaneState._fields)
    g = torch.Generator().manual_seed(3)
    lengths = torch.tensor([0, 1, 3, 4, 5, 7, 8, 9], dtype=torch.int32)
    parts = [kvplane.local_plane(cfg, whole, r, n) for r in range(n)]
    b = cfg.batch // n
    for _ in range(2):
        k = torch.randn((8, 2, 8), generator=g)
        v = torch.randn((8, 2, 8), generator=g)
        q = torch.randn((8, 4, 8), generator=g)
        kvplane.append_dense(cfg, whole, k, v, lengths)
        out, _ = kvplane.attend_dense(cfg, whole, q, lengths + 1)
        for r, p in enumerate(parts):
            sl = slice(r * b, (r + 1) * b)
            kvplane.append_dense(lc, p, k[sl], v[sl], lengths[sl])
            o, _ = kvplane.attend_dense(lc, p, q[sl], lengths[sl] + 1)
            assert torch.equal(o, out[sl])
        lengths = lengths + 1
    joined = kvplane.concat_planes(cfg, parts)
    for k in kvplane.KVPlaneState._fields:
        assert torch.equal(joined.view(cfg, k), whole.view(cfg, k)), k
    for r, p in enumerate(parts):
        again = kvplane.local_plane(cfg, whole, r, n)
        for k in kvplane.KVPlaneState._fields:
            assert torch.equal(again.view(lc, k), p.view(lc, k)), (r, k)


def test_local_expert_planes_concatenate_to_the_plain_plane():
    cfg = expertplane.ExpertPlaneConfig(n_experts=6, d_model=8, d_ff=4,
                                        hot_slots=3, topk=2, fetch_budget=2,
                                        dtype=torch.float32)
    s = expertplane.init(cfg, "cpu")
    g = torch.Generator().manual_seed(4)
    for k in ("hot_wi", "hot_wg", "hot_wo"):
        getattr(s, k).normal_(generator=g)
    s.slot_of[:3] = torch.tensor([2, 0, 1], dtype=torch.int32)
    parts = [expertplane.local_plane(s, r, 4) for r in range(4)]
    assert parts[1].hot_wi.shape == (4, 2, 4)
    assert parts[1].hot_wo.shape == (4, 4, 2)
    assert torch.equal(parts[1].hot_wi, s.hot_wi[:, 2:4])
    _same(expertplane.concat_planes(parts), s,
          expertplane.ExpertPlaneState._fields)
    with pytest.raises(ValueError, match="evenly"):
        expertplane.local_plane(s, 0, 3)


def test_local_expert_plane_keeps_its_chunk_through_a_step(monkeypatch):
    """kimi-k2's smoke decode step on a fake 8-rank (4, 2) mesh, in one
    process (meta shards): each layer's local plane holds its d_model
    chunk of the hot store, [S, d/4, F] and [S, F, d/4] beside its trash
    slot, before and after the step, and the experts' products take that
    chunk of the dispatched tokens."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import api
    cfg = configs.get_smoke("kimi-k2-1t-a32b")
    shape = configs.ShapeConfig("smoke", 64, 8, "decode")
    S, d, F = api._expert_cfg(cfg).hot_slots, cfg.d_model, cfg.d_ff
    seen = []
    real = expertplane._experts

    def spy(cfg_, s, xe, reduce):
        seen.append((tuple(xe.shape), tuple(s.hot_wg.shape)))
        return real(cfg_, s, xe, reduce)
    monkeypatch.setattr(expertplane, "_experts", spy)
    with dryrun.fake_world(8):
        mesh = M.make_host_mesh(4, 2, device_type="cpu")
        fn, args, specs = dryrun.build_cell(cfg, shape, mesh)
        params, state, tok = dryrun.lay_out(args, specs, mesh, "decode",
                                            cfg, shape)

        def shapes(st):
            return [(p.hot_wi.shape, p.hot_wg.shape, p.hot_wo.shape)
                    for p in st.extra]
        want = [((S + 1, d // 4, F),) * 2 + ((S + 1, F, d // 4),)] * \
            cfg.n_layers
        assert shapes(state) == want
        with M.use_mesh(mesh), implicit_replication():
            new, _ = fn(params, state, tok)
        assert shapes(new) == want
        assert [p is q for p, q in zip(new.extra, state.extra)] == \
            [True] * cfg.n_layers
    assert len(seen) == cfg.n_layers
    for xe, wg in seen:
        assert xe[0] == S and xe[2] == d // 4 and wg == (S + 1, d // 4, F)


def test_a_sparse_plane_does_not_split_by_batch():
    cfg = kvplane.KVPlaneConfig(kv_heads=1, head_dim=4, page_tokens=4,
                                num_pages=8, num_frames=4, batch=1,
                                sparse_topk=2, fetch_budget=2)
    with pytest.raises(ValueError, match="shards"):
        kvplane.local_config(cfg, 2)
    dense = dataclasses.replace(cfg, sparse_topk=0, batch=3, num_frames=24)
    with pytest.raises(ValueError, match="evenly"):
        kvplane.local_config(dense, 2)


# --------------------------------------------------------------------------
# the rank's side
# --------------------------------------------------------------------------

def _planes(api, state):
    """Every KV plane of a serve state (each shard of a sparse layer)."""
    out = []
    for kv in state.kv:
        kv = kv.get("attn_kv") if isinstance(kv, dict) else kv
        if kv is None:
            continue
        out += kv if isinstance(kv, list) else [kv]
    return out


def seeded_state(api, cfg, shape, shards: int, prefix: list):
    """A plain serve state with seeded K/V in every plane (slab pages and
    their summaries in sparse mode, frames otherwise), seeded cross
    memory, ``prefix`` tokens already in context."""
    state = api.init_decode_state(cfg, shape, shards=shards, device="cpu")
    g = torch.Generator().manual_seed(11)
    _, mode = api.kv_plan(cfg, shape, shards)
    for p in _planes(api, state):
        if mode == "sparse":
            p.k_slab.normal_(generator=g).mul_(0.1)
            p.v_slab.normal_(generator=g)
            p.kmax.copy_(p.k_slab.amax(dim=2).float())
            p.kmin.copy_(p.k_slab.amin(dim=2).float())
        else:
            p.k_frames.normal_(generator=g)
            p.v_frames.normal_(generator=g)
    if cfg.family == "encdec":
        for t in state.extra["k"] + state.extra["v"]:
            t.normal_(generator=g)
    state.lengths.copy_(torch.tensor(prefix, dtype=torch.int32))
    return state


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _close(got, want, what):
    got, want = _full(got).double(), want.double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = torch.isfinite(want)      # e.g. an empty page's -inf summary
    assert torch.equal(torch.isfinite(got), fin), what
    assert torch.equal(got[~fin], want[~fin]), what
    got, want = got[fin], want[fin]
    err = float((got - want).abs().max()) if got.numel() else 0.0
    top = float(want.abs().max()) if want.numel() else 0.0
    assert err <= TOL * max(top, 1e-30), (what, err, top)


def _compare(got, want, path=""):
    """Two ``convert.serve_state_to_numpy`` trees: ints and bools equal,
    floats within TOL of the largest."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _compare(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _compare(a, b, f"{path}/{i}")
        return
    a, b = np.asarray(got), np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                      b.dtype)
    if np.issubdtype(b.dtype, np.floating):
        _close(torch.from_numpy(a), torch.from_numpy(b), path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def check_decode(arch, kind, seq, batch, prefix, mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs, convert
    from repro_torch.launch import mesh as M
    from repro_torch.models import api
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    shape = configs.ShapeConfig("smoke", int(seq), int(batch), kind)
    shards = M.axis_size(mesh, "dp") if kind == "decode_long" else 1
    prefix = [int(p) for p in prefix.split(",")]
    params = api.init_params(cfg, seed=3, device="cpu")
    plain = seeded_state(api, cfg, shape, shards, prefix)
    state = api.serve_state_on_mesh(cfg, shape, plain.clone(), mesh, shards)
    dparams = M.distribute_tree(tree_map(torch.clone, params), mesh,
                                api.param_pspecs(cfg))
    tok_spec = api.batch_specs(cfg, shape)["tokens"][1]
    tok = torch.arange(int(batch), dtype=torch.int32) * 37 % cfg.vocab
    step = api.decode_step(cfg, shape, shards=shards)
    for i in range(STEPS):
        plain, want = step(params, plain, tok)
        with M.use_mesh(mesh), implicit_replication():
            state, got = step(dparams, state, M.distribute(tok, mesh,
                                                           tok_spec))
        _close(got, want, f"logits of step {i}")
        tok = want.argmax(dim=-1).to(torch.int32)
    whole = api.serve_state_whole(cfg, shape, state, mesh, shards)
    _compare(convert.serve_state_to_numpy(cfg, shape, whole, shards),
             convert.serve_state_to_numpy(cfg, shape, plain, shards))


def _rank_main(rank: int, init: str, cases: list) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_far(rank, WORLD, init, device="cpu")
    try:
        mesh = M.make_host_mesh(2, 2, device_type="cpu")
        for case in cases:
            t0 = time.time()
            check_decode(*case.split(":"), mesh)
            print(f"rank {rank}: {case} ok ({time.time() - t0:.1f}s)",
                  flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3:])
