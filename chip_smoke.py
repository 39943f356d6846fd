#!/usr/bin/env python3
"""Drive the PyTorch port of the hybrid far-memory plane on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown of
                                     # 16 serving ticks

Phases (any failure exits non-zero, with no result line):

 1. device    the card's name and power limit (nvidia-smi)
 2. build     the CUDA kernels, compiled from src/repro_torch/kernels/csrc
 3. kernels   each CUDA kernel against its plain PyTorch version on the
              card, at the shapes the serving path gives it, with times
 4. oracles   at 512 objects: the batched executor against the scalar
              reference executor, bit for bit, on mcd_cl and df_scan traffic
              with evacuations and epochs; a pipelined engine against a
              sync engine
 5. serve     8,388,608 objects through the launcher's plane recipe and the
              pipelined engine, 256 ticks of mcd_cl at batch 1024; every
              served row checked on the card against the data
 6. no sync   50 more ticks of plan/execute/evacuate/epoch under
              torch.cuda.set_sync_debug_mode("error")
 7. writes    update, read back; writeback + evict everything, read again
 8. invariants of the final full-size state

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA GPU and the repository's
sources beside this file; it never runs on the CPU.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

OBJECTS = 8_388_608
BATCH = 1024
SERVE_TICKS = 256
NOSYNC_TICKS = 50
SEED = 0
# published HBM rate of the card (bytes/s), by product name
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------
# timing on the card
# --------------------------------------------------------------------------

def device_ms(torch, fn, n: int = 40, rounds: int = 5) -> float:
    """Median device time of one call, in ms.  A sleep kernel holds the
    stream while the host queues ``n`` calls, so the events time the calls
    back to back on the device, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    return 3.35e12


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={torch.cuda.device_count()}")
    return name, card


def phase_build(build) -> None:
    t0 = time.time()
    so = build.build()
    build.load_library()
    log(f"[build] {so.name} in {time.time() - t0:.1f}s "
        f"(nvcc {build.build_seconds:.1f}s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log(f"[build]   {line.strip()}")


def phase_kernels(torch, ops, ref, state, card: str, rate: float) -> list:
    """Each kernel against its plain version at the serving path's shapes;
    exact for the copies, bit for bit for the CAR EMA."""
    dev = state.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    P, D = state.slab.shape[1], state.slab.shape[2]
    slab_rows = state.slab.view(-1, D)             # full-size slab view
    n_rows = slab_rows.shape[0] - P                # trash page excluded
    results = []

    def idx_sets(n_sets, r, hi, p_masked):
        out = []
        for _ in range(n_sets):
            i = torch.randint(0, hi, (r,), generator=g, device=dev,
                              dtype=torch.int32)
            drop = torch.rand((r,), generator=g, device=dev) < p_masked
            out.append(torch.where(drop, -1, i))
        return out

    def record(name, source, replaces, kern, plain, lib, out_k, out_p,
               bytes_moved, exact_bits=False):
        if exact_bits:
            same = torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
        else:
            same = torch.equal(out_k, out_p)
        err = float((out_k.float() - out_p.float()).abs().max())
        check(same, f"{name}: kernel disagrees with its plain version "
                    f"(max abs err {err})")
        ms = device_ms(torch, kern)
        plain_ms = device_ms(torch, plain)
        lib_ms = device_ms(torch, lib) if lib is not None else None
        bound_ms = bytes_moved / rate * 1e3
        results.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=0,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by="bytes",
                            library_ms=lib_ms))
        log(f"[kernel] {name}: equal to plain (tolerance 0"
            f"{', bit for bit' if exact_bits else ''}); {ms * 1e3:.2f} us "
            f"(plain {plain_ms * 1e3:.2f} us, "
            f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
            f"bound {bound_ms * 1e3:.3f} us by {bytes_moved:.0f} B) [{card}]")

    def cycler(items):
        """Each call the next input set: the serving path finds its rows
        cold in L2, so the timed calls do not reuse one index set."""
        pos = [0]

        def nxt():
            pos[0] += 1
            return items[pos[0] % len(items)]
        return nxt

    def mean_valid(sets):
        return sum(int((x >= 0).sum()) for x in sets) / len(sets)

    # gather_rows: R=1024 object rows of D=32 f32 over the full slab view
    sets = idx_sets(16, BATCH, n_rows, 0.5)
    idx = sets[0]
    row_b = D * slab_rows.element_size()
    valid = mean_valid(sets)
    pick, pick_c = cycler(sets), cycler([x.clamp_min(0) for x in sets])
    record("gather_rows", "src/repro_torch/kernels/csrc/gather_rows.cu",
           "src/repro/kernels/gather_objects.py:31",
           lambda: ops.gather_rows(slab_rows, pick()),
           lambda: ref.gather_rows_ref(slab_rows, pick()),
           lambda: slab_rows.index_select(0, pick_c()),
           ops.gather_rows(slab_rows, idx), ref.gather_rows_ref(slab_rows, idx),
           valid * row_b + BATCH * row_b + BATCH * 4)

    # gather_pages: R+Q pages of P*D through the same kernel, one 1 KiB
    # page per row (timed on the page view; the wrapper's own index math
    # is a few more small launches)
    V = state.slab.shape[0] - 1
    Q = 8
    psets = idx_sets(16, BATCH + Q, V, 0.5)
    page_rows = state.slab.view(-1, P * D)
    pvalid = mean_valid(psets)
    page_b = P * row_b
    pick, pick_c = cycler(psets), cycler([x.clamp_min(0) for x in psets])
    k_ms = device_ms(torch, lambda: ops.gather_rows(page_rows, pick()))
    p_ms = device_ms(torch, lambda: ref.gather_rows_ref(page_rows, pick()))
    l_ms = device_ms(torch, lambda: page_rows.index_select(0, pick_c()))
    w_ms = device_ms(torch, lambda: ops.gather_pages(state.slab[None],
                                                     pick()))
    check(torch.equal(ops.gather_pages(state.slab[None], psets[0]),
                      ops.gather_pages(state.slab[None], psets[0],
                                       impl="ref")),
          "gather_pages: kernel disagrees with its plain version")
    pb = pvalid * page_b + (BATCH + Q) * page_b + (BATCH + Q) * 4
    log(f"[kernel] gather_rows on 1 KiB page rows (gather_pages, R+Q="
        f"{BATCH + Q}): equal to plain; {k_ms * 1e3:.2f} us (plain "
        f"{p_ms * 1e3:.2f} us, library {l_ms * 1e3:.2f} us, whole "
        f"gather_pages wrapper {w_ms * 1e3:.2f} us, bound "
        f"{pb / rate * 1e6:.3f} us by {pb:.0f} B) [{card}]")

    # compact_pages: M=4 destination pages of P=8 rows of D=32 (frame pool)
    frame_rows = state.frames.view(-1, D)
    nf = frame_rows.shape[0] - P
    plans = idx_sets(16, 4 * P, nf, 0.25)
    plan = plans[0]
    pick, pick_c = cycler(plans), cycler([x.clamp_min(0) for x in plans])
    cvalid = mean_valid(plans)
    record("compact_pages", "src/repro_torch/kernels/csrc/compact_pages.cu",
           "src/repro/kernels/compact.py:31",
           lambda: ops.compact_pages(frame_rows, pick(), page_objs=P),
           lambda: ref.compact_pages_ref(frame_rows, pick(), P),
           lambda: frame_rows.index_select(0, pick_c()),
           ops.compact_pages(frame_rows, plan, page_objs=P),
           ref.compact_pages_ref(frame_rows, plan, P),
           cvalid * row_b + 4 * P * row_b + 4 * P * 4)

    # cat_decay: V=3,145,728 pages of P=8 cards
    cat = torch.rand((V, P), generator=g, device=dev) < 0.3
    ema = torch.rand((V,), generator=g, device=dev)
    alloc = torch.randint(0, P + 1, (V,), generator=g, device=dev,
                          dtype=torch.int32)
    decay = 0.5
    record("cat_decay", "src/repro_torch/kernels/csrc/cat_decay.cu",
           "src/repro/kernels/cat_decay.py:38",
           lambda: ops.cat_decay(cat, ema, alloc, decay=decay),
           lambda: ref.cat_decay_ref(cat, ema, alloc, decay),
           None,
           ops.cat_decay(cat, ema, alloc, decay=decay),
           ref.cat_decay_ref(cat, ema, alloc, decay),
           V * P + 12 * V, exact_bits=True)
    # a decay whose 1 - decay is inexact in f32 (0.7 -> 0.3)
    check(torch.equal(ops.cat_decay(cat, ema, alloc, decay=0.7).view(
        torch.int32), ref.cat_decay_ref(cat, ema, alloc, 0.7).view(
            torch.int32)), "cat_decay(0.7): not bit-exact")
    torch.cuda.synchronize()
    return results


def _states_equal(torch, convert, a, b) -> bool:
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    import numpy as np
    for k in x:
        if k == "stats":
            if any(not np.array_equal(x[k][kk], y[k][kk]) for kk in x[k]):
                return False
        elif not np.array_equal(x[k], y[k]):
            return False
    return True


def phase_oracles(torch, m) -> None:
    """Small-size oracles on the card."""
    import numpy as np
    dev = torch.device("cuda")
    objects, batch = 512, 32
    pcfg = m.serve.kv_plane_config(objects, 0.25)
    data = m.serve.kv_data(objects, SEED)
    data_t = torch.from_numpy(data).to(dev)
    for wl in ("mcd_cl", "df_scan"):
        sb = m.state.create(pcfg, data_t, device=dev)
        sr = sb.clone()
        gen = m.kvworkload.WORKLOADS[wl](objects, batch, 24, seed=SEED)
        for t, ids in enumerate(gen):
            ids_t = torch.from_numpy(ids).to(dev)
            _, rb = m.plane.access(pcfg, sb, ids_t, mode="batch")
            _, rr = m.plane.access(pcfg, sr, ids_t, mode="reference")
            check(torch.equal(rb, rr) and torch.equal(rb, data_t[ids_t]),
                  f"oracle {wl}: rows differ at tick {t}")
            if t % 6 == 5:
                for s in (sb, sr):
                    m.plane.evacuate(pcfg, s, garbage_threshold=-1.0,
                                     max_pages=4)
                    m.plane.advance_epoch(pcfg, s)
            check(_states_equal(torch, m.convert, sb, sr),
                  f"oracle {wl}: batch and reference states differ at "
                  f"tick {t}")
        check(all(m.plane.check_invariants(pcfg, sb).values()),
              f"oracle {wl}: invariants")
        st = {k: int(v) for k, v in sb.stats._asdict().items()}
        log(f"[oracle] {wl}: batch == reference executor over 24 ticks "
            f"(misses={st['misses']} page_ins={st['page_ins']} "
            f"obj_ins={st['obj_ins']} evac_pages={st['evac_pages']} "
            f"epochs={st['epochs']})")
    engines = {}
    for disp in ("pipelined", "sync"):
        engines[disp] = m.engine.Engine(
            m.engine.EngineConfig(batch=batch, dispatch=disp, evac_every=8,
                                  epoch_every=4), pcfg, data, device=dev)
    batches = list(m.kvworkload.zipf_churn(objects, batch, 30, seed=SEED))
    outs = [engines["pipelined"].submit(b) for b in batches]
    engines["pipelined"].drain()
    for i, b in enumerate(batches):
        rs = engines["sync"].serve_batch(b)
        check(torch.equal(outs[i], rs) and
              torch.equal(rs, data_t[torch.from_numpy(b).to(dev)]),
              f"pipelined engine rows differ at batch {i}")
    check(_states_equal(torch, m.convert, engines["pipelined"].state,
                        engines["sync"].state),
          "pipelined and sync engine states differ")
    log("[oracle] pipelined engine == sync engine over 30 ticks")
    # tie order of the stable sort on the card (lax.top_k's order)
    x = torch.randint(0, 3, (4096,), device=dev, dtype=torch.int32)
    _, order = m.batch.stable_order(x)
    want = np.argsort(x.cpu().numpy(), kind="stable")
    check(np.array_equal(order.cpu().numpy(), want), "stable sort ties")
    _, order = m.batch.stable_order(x.float(), descending=True)
    want = np.argsort(-x.cpu().numpy(), kind="stable")
    check(np.array_equal(order.cpu().numpy(), want), "stable sort ties desc")
    log("[oracle] stable sort keeps ties in index order on the card")


def phase_profile(torch, plane, eng, ids_all, first: int, n: int,
                  card: str):
    """Where the serving time goes, under torch.profiler: ``n`` sync ticks
    (device time by kernel, device operations, the device's busy share of
    the wall time), then one foreground evacuation and one epoch."""
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn, reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        rows = []  # device-side events only: each kernel and memcpy once
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0)),
                             e.count, e.key))
        busy = sum(r[0] for r in rows) / 1e6
        ops = sum(r[1] for r in rows)
        return wall / reps, busy / reps, ops / reps, rows

    ticks = iter(range(first, first + n))

    def tick():
        eng.submit(ids_all[next(ticks)])
        eng.drain()
    wall, busy, ops, rows = profiled(tick, n)
    log(f"[profile] {n} sync ticks: wall {wall * 1e3:.2f} ms/tick, device "
        f"busy {busy * 1e3:.3f} ms/tick ({100 * busy / wall:.1f}% of wall), "
        f"{ops:.0f} device ops/tick [{card}]")
    for dev, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {dev / 1e3 / n:8.3f} ms/tick {count / n:7.1f} "
            f"per tick  {key[:90]}")
    for name, fn in (("evacuate (16 victims)",
                      lambda: plane.evacuate(eng.pcfg, eng.state)),
                     ("advance_epoch",
                      lambda: plane.advance_epoch(eng.pcfg, eng.state))):
        wall, busy, ops, _ = profiled(fn, 1)
        log(f"[profile] {name}: wall {wall * 1e3:.2f} ms, device busy "
            f"{busy * 1e3:.3f} ms, {ops:.0f} device ops [{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import batch, plane, state
    from repro_torch.data import kvworkload
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    class M:  # the port's modules, for the phases
        pass
    for mod in (convert, batch, plane, state, kvworkload, serve, engine):
        setattr(M, mod.__name__.rsplit(".", 1)[-1], mod)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    name, card = phase_device(torch)
    rate = hbm_rate(name)
    phase_build(_build)
    dev = torch.device("cuda")

    # ---- the full-size plane (the launcher's recipe) ----------------------
    # evac_garbage_threshold=-1: in this run the frame pool (25% of the data
    # pages) never fills, so no local page ever holds a dead slot; with -1
    # every local unpinned page is eligible and the compactor does real
    # work each round (as the serving tests of the JAX package do)
    pcfg = serve.kv_plane_config(OBJECTS, 0.25, evac_garbage_threshold=-1.0)
    t0 = time.time()
    data = serve.kv_data(OBJECTS, SEED)
    data_t = torch.from_numpy(data).to(dev)
    ecfg = engine.EngineConfig(plane="hybrid", batch=BATCH,
                               dispatch="pipelined", evac_every=64,
                               epoch_every=16)
    eng = engine.Engine(ecfg, pcfg, data_t, device=dev)
    torch.cuda.synchronize()
    log(f"[serve] plane: {OBJECTS} objects, slab "
        f"{tuple(eng.state.slab.shape)} ({eng.state.slab.nbytes / 1e9:.2f} "
        f"GB), frames {tuple(eng.state.frames.shape)} "
        f"({eng.state.frames.nbytes / 1e6:.0f} MB), set up in "
        f"{time.time() - t0:.1f}s")

    kernels = phase_kernels(torch, ops, ref, eng.state, card, rate)
    phase_oracles(torch, M)

    # ---- serve at full size ----------------------------------------------
    wl = np.stack(list(kvworkload.zipf_churn(
        OBJECTS, BATCH, SERVE_TICKS + NOSYNC_TICKS, seed=SEED)))
    ids_all = torch.from_numpy(wl).to(dev)
    mism = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.latency = engine.LatencyTracker()
    tick_ms = []
    t0 = time.time()
    for t in range(SERVE_TICKS):
        ts = time.time()
        rows = eng.submit(ids_all[t])
        mism += (rows != data_t[ids_all[t]]).any(dim=1).sum()
        tick_ms.append((time.time() - ts) * 1e3)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    n_mism = int(mism)
    stats = {k: int(v) for k, v in eng.state.stats._asdict().items()}
    lat = eng.latency.summary()
    log(f"[serve] {SERVE_TICKS} ticks x {BATCH} requests (mcd_cl) in "
        f"{wall:.3f}s: {SERVE_TICKS * BATCH / wall:.0f} requests/s, batch "
        f"latency p50 {lat['p50_us']:.0f} us p99 {lat['p99_us']:.0f} us, "
        f"host submit p50 {statistics.median(tick_ms):.2f} ms [{card}]")
    log(f"[serve] stats {stats}")
    log(f"[serve] kernel launches {launches} "
        f"({ {k: v / SERVE_TICKS for k, v in launches.items()} } per tick)")
    check(n_mism == 0, f"{n_mism} served rows differ from the data")
    for k in ("page_ins", "obj_ins", "evac_pages", "epochs"):
        check(stats[k] > 0, f"serve: {k} is 0")
    for k, v in launches.items():
        check(v > 0, f"serve: kernel {k} was never launched")
    log(f"[serve] 0 of {SERVE_TICKS * BATCH} served rows differ from the data")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if "--profile" in sys.argv:
        phase_profile(torch, plane, eng, ids_all, 0, 16, card)

    # ---- the plane's path makes no host sync -----------------------------
    s = eng.state
    mism.zero_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(SERVE_TICKS, SERVE_TICKS + NOSYNC_TICKS):
            ids = ids_all[t]
            p = batch.plan_access(pcfg, s, ids)
            _, rows = batch.execute_access(pcfg, s, ids, p)
            mism += (rows != data_t[ids]).any(dim=1).sum()
            if t % 16 == 0:
                plane.evacuate(pcfg, s)
            if t % 8 == 0:
                plane.advance_epoch(pcfg, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(int(mism) == 0, "rows differ under sync-debug mode")
    log(f"[nosync] {NOSYNC_TICKS} ticks of plan_access/execute_access/"
        f"evacuate/advance_epoch under set_sync_debug_mode('error'): "
        f"no host sync, rows correct")

    # ---- writes read back -------------------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    ids = torch.randperm(OBJECTS, generator=g, device=dev)[:BATCH].to(
        torch.int32)
    new = torch.rand((BATCH, 32), generator=g, device=dev)
    plane.update(pcfg, s, ids, new)
    _, got = plane.access(pcfg, s, ids)
    check(torch.equal(got, new), "written rows do not read back")
    plane.writeback_all(pcfg, s)
    plane.evict_all(pcfg, s)
    # only the pinned log cursors (ingress fill, evacuation hot/cold) stay
    F, P = pcfg.num_frames, pcfg.page_objs
    check(int((s.vpage_of[:F] >= 0).sum()) <= 3, "evict_all left frames")
    loc = s.obj_loc[ids.long()]
    far = s.backing[(loc // P).long()] != 1
    check(bool(far.any()) and torch.equal(
        s.slab.view(-1, 32)[loc.long()][far], new[far]),
        "the slab does not hold the written rows after writeback + evict")
    _, got = plane.access(pcfg, s, ids)
    check(torch.equal(got, new), "written rows do not read back from the "
                                 "slab after writeback + evict")
    data_t[ids.long()] = new
    other = ids_all[0]
    _, got = plane.access(pcfg, s, other)
    check(torch.equal(got, data_t[other]), "unwritten rows changed")
    log(f"[writes] {BATCH} updated rows read back, before and after "
        f"writeback_all + evict_all ({int(far.sum())} of them from the "
        f"slab)")

    # ---- invariants -------------------------------------------------------
    inv = plane.check_invariants(pcfg, s)
    check(all(inv.values()), f"invariants: {inv}")
    log(f"[invariants] all hold on the final full-size state: {sorted(inv)}")

    log(f"[done] {time.time() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
