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
 9. kernels   page_scores, paged_attention (the long_500k sparse step and
              the decode_32k batch; the other shapes either path takes;
              granite-20b's and paligemma-3b's widths) and cat_update
              against their plain versions at llama3-8b's widths, with
              times, bounds and the library call where there is one; every
              bf16 paged_attention call on the tensor cores, and a repeat
              call the same bits
10. kvoracle  at a small size: the KV plane's batched fetch executor
              against its reference executor, bit for bit (attend_sparse
              with each lookahead mode; sharded_sparse_decode, 2 shards)
11. kvsparse  llama3-8b long_500k, one layer (slab [8, 8192, 64, 128]
              bf16): 128 attend_sparse steps, both kernels every step and
              checked against their plain versions on 23 of them; frames
              against the slab; PSF flips and packed fetches; a profile of
              16 steps (paged_attention one kernel a step, no combine
              launch); 32 steps under set_sync_debug_mode("error")
12. kvdense   llama3-8b decode_32k, one layer (B=128, 65,536 frames): 8
              append_dense + attend_dense steps against an f32
              recomputation on 4 sequences
Every paged_attention launch of 11 and 12 is on the tensor cores.

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
# published dense peaks of an H100 SXM (operations/s)
PEAK_F32, PEAK_BF16 = 67e12, 989e12
# the KV plane at llama3-8b's widths (src/repro/configs/llama3_8b.py: 32
# query heads, 8 kv heads, head_dim 128) with the plane's 64-token pages
# (src/repro/models/api.py): long_500k through api._kv_cfg_sparse with one
# shard, decode_32k through api._kv_cfg_dense; one layer each
LLAMA_HEADS, LLAMA_KV_HEADS, LLAMA_HEAD_DIM, PAGE_TOKENS = 32, 8, 128, 64
SPARSE_PAGES, SPARSE_FRAMES, SPARSE_TOPK, SPARSE_FETCH = 8192, 96, 64, 4
DENSE_BATCH, DENSE_PAGES = 128, 512
# the decode_32k sequences held to the plain version
DENSE_CHECKED = [0, 1, 64, 127]
# granite-20b (48 query heads over 1 kv head, head_dim 128) and paligemma-3b
# (8 over 1, head_dim 256; src/repro/configs/): decode over 32 sequences
WIDE_BATCH = 32
KV_STEPS, KV_NOSYNC, DENSE_STEPS = 128, 32, 8
# cat_update at the hybrid plane's CAT: 3,145,728 pages of 8 cards
CAT_PAGES, CAT_CARDS, CAT_TOUCHES = 3_145_728, 8, 1024


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


# --------------------------------------------------------------------------
# the KV serve plane (kvplane) at llama3-8b's widths
# --------------------------------------------------------------------------

def bound(bytes_moved: float, ops: float, rate: float, peak: float):
    """(ms, "bytes" or "operations"): the least time for this work."""
    t_b, t_o = bytes_moved / rate, ops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def kv_record(name, source, replaces, ms, plain_ms, lib_ms, err, bnd):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms)


def used_borderline(torch, q, kf, vf, table, lens):
    """[B, NP, P] bool: rows whose weight is within 1e-5*mass of the card
    signal's threshold (w*P = page mass) for some query head, computed as
    the plain version computes w.  There the kernel's other summation
    order may decide the other way."""
    B, H, Dh = q.shape
    KVH, _, P, _ = kf.shape
    NP = table.shape[1]
    G = H // KVH
    safe = table.clamp_min(0).long()
    k = kf[:, safe].float().permute(1, 0, 2, 3, 4).reshape(B, KVH, NP * P, Dh)
    sc = torch.einsum("bkgd,bksd->bkgs", q.reshape(B, KVH, G, Dh).float(), k)
    sc = sc / Dh ** 0.5
    row = torch.arange(P, device=q.device).repeat(NP)
    valid = ((row[None] < lens.repeat_interleave(P, dim=1))
             & (table >= 0).repeat_interleave(P, dim=1))[:, None, None]
    e = torch.where(valid, torch.exp(sc - sc.masked_fill(~valid, -torch.inf)
                                     .amax(-1, keepdim=True)), 0.0)
    w = (e / e.sum(-1, keepdim=True).clamp_min(1e-30)).reshape(
        B, KVH, G, NP, P)
    mass = w.sum(-1, keepdim=True)
    near = (w * P - mass).abs() <= 1e-5 * mass
    return near.any(dim=2).any(dim=1) & valid.reshape(B, NP, P)


def attention_tol(torch, out_p) -> float:
    """Paged attention's absolute tolerance: 2e-2 (bf16) or 2e-5 (f32), the
    limits tests/test_kernels.py holds the Pallas kernel to, times the
    largest plain output.  Outputs shrink with the rows attended (about
    0.04 at most over 32,768 rows of N(0,1) data), so a fixed limit would
    pass a kernel that returns half of every value; this one is 2.5 bf16
    ulps of the largest output, and 40x the f32 rounding of the plain
    version against f64."""
    rel = 2e-2 if out_p.dtype == torch.bfloat16 else 2e-5
    return rel * float(out_p.float().abs().max())


def check_attention(torch, name, out_k, used_k, out_p, used_p, border):
    """out within attention_tol of the plain version; used equal except on
    borderline rows."""
    tol = attention_tol(torch, out_p)
    err = float((out_k.float() - out_p.float()).abs().max())
    check(err <= tol, f"{name}: out differs from the plain version by {err} "
                      f"(tolerance {tol:.3g})")
    diff = used_k != used_p
    n_border = int(border.sum())
    check(not bool((diff & ~border).any()),
          f"{name}: used differs on {int((diff & ~border).sum())} rows that "
          f"are not within rounding of the threshold")
    return err, int(diff.sum()), n_border


def check_repeat(torch, ops, name, out, used, args):
    """A second call on the same inputs gives the same bits."""
    o2, u2 = ops.paged_attention(*args)
    check(torch.equal(o2.view(torch.int16), out.view(torch.int16))
          and torch.equal(u2, used),
          f"{name}: a repeat call on the same inputs gave other bits")


def sdpa_fn(torch, q, k, v):
    """One scaled_dot_product_attention call (GQA) on K/V already gathered
    contiguous ([B, KVH, L, Dh]); q [B, H, Dh]."""
    q4 = q[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k, v, enable_gqa=True)


def phase_kv_kernels(torch, ops, ref, card: str, rate: float) -> list:
    """page_scores, paged_attention (sparse and dense shapes) and
    cat_update against their plain versions at llama3-8b's full widths."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    bf16 = torch.bfloat16
    KVH, H, Dh, P = LLAMA_KV_HEADS, LLAMA_HEADS, LLAMA_HEAD_DIM, PAGE_TOKENS
    G = H // KVH
    out = []
    qs = [torch.randn((1, H, Dh), generator=g, device=dev, dtype=bf16)
          for _ in range(8)]

    def cyc(items):
        pos = [0]

        def nxt():
            pos[0] += 1
            return items[pos[0] % len(items)]
        return nxt

    # ---- page_scores: long_500k summaries, [8, 8192, 128] f32 ------------
    NP = SPARSE_PAGES
    kmax = torch.randn((KVH, NP, Dh), generator=g, device=dev)
    kmin = kmax - torch.rand((KVH, NP, Dh), generator=g, device=dev)
    got = ops.page_scores(qs[0], kmax, kmin)
    want = ref.page_scores_ref(qs[0], kmax, kmin)
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    check(err <= tol, f"page_scores: max abs err {err} > {tol}")
    pick = cyc(qs)
    ms = device_ms(torch, lambda: ops.page_scores(pick(), kmax, kmin))
    plain_ms = device_ms(torch, lambda: ref.page_scores_ref(pick(), kmax,
                                                            kmin), n=10)
    nbytes = 2 * KVH * NP * Dh * 4 + H * Dh * 2 + KVH * NP * 4
    bnd = bound(nbytes, 4 * G * KVH * NP * Dh, rate, PEAK_F32)
    log(f"[kernel] page_scores {list(qs[0].shape)} bf16 x {[KVH, NP, Dh]} f32: max "
        f"abs err {err:.3g} (tolerance {tol:.3g}); {ms * 1e3:.2f} us (plain "
        f"{plain_ms * 1e3:.2f} us, library none, bound {bnd[0] * 1e3:.2f} us "
        f"by {bnd[1]}) [{card}]")
    out.append(kv_record("page_scores",
                         "src/repro_torch/kernels/csrc/page_scores.cu",
                         "src/repro/kernels/topk_pages.py:36", ms, plain_ms,
                         None, err, bnd))
    del kmax, kmin

    # ---- paged_attention, sparse step: 64 selected pages of 96 frames -----
    F, K = SPARSE_FRAMES, SPARSE_TOPK
    kf = torch.randn((KVH, F + 1, P, Dh), generator=g, device=dev, dtype=bf16)
    vf = torch.randn((KVH, F + 1, P, Dh), generator=g, device=dev, dtype=bf16)
    tables = [torch.randperm(F, generator=g, device=dev)[:K].to(
        torch.int32)[None] for _ in range(8)]
    lens = torch.full((1, K), P, dtype=torch.int32, device=dev)
    from repro_torch.kernels import paged_attention as tpattn
    n_mma = tpattn.launches_mma
    o_k, u_k = ops.paged_attention(qs[0], kf, vf, tables[0], lens)
    check(tpattn.launches_mma == n_mma + 1,
          "paged_attention (sparse): not launched on the tensor cores")
    o_p, u_p = ref.paged_attention_ref(qs[0], kf, vf, tables[0], lens)
    border = used_borderline(torch, qs[0], kf, vf, tables[0], lens)
    err, n_diff, n_border = check_attention(torch, "paged_attention (sparse)",
                                            o_k, u_k, o_p, u_p, border)
    check_repeat(torch, ops, "paged_attention (sparse)", o_k, u_k,
                 (qs[0], kf, vf, tables[0], lens))
    pq, pt = cyc(qs), cyc(tables)
    ms = device_ms(torch, lambda: ops.paged_attention(pq(), kf, vf, pt(),
                                                      lens))
    plain_ms = device_ms(torch, lambda: ref.paged_attention_ref(
        pq(), kf, vf, pt(), lens), n=10)
    kg = kf[:, tables[0][0].long()].reshape(1, KVH, K * P, Dh).contiguous()
    vg = vf[:, tables[0][0].long()].reshape(1, KVH, K * P, Dh).contiguous()
    lib_ms = device_ms(torch, sdpa_fn(torch, qs[0], kg, vg))
    nbytes = 2 * KVH * K * P * Dh * 2 + 2 * H * Dh * 2 + K * P + 8 * K
    bnd = bound(nbytes, 4 * G * Dh * K * P * KVH, rate, PEAK_BF16)
    log(f"[kernel] paged_attention sparse (B=1, {K} pages of {P} rows, bf16): "
        f"max abs err {err:.3g} (tolerance 2e-2 x the largest output), used "
        f"differs on {n_diff} "
        f"rows, {n_border} rows within 1e-5*mass of the threshold; "
        f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, library "
        f"scaled_dot_product_attention on K/V gathered contiguous, without "
        f"the gather and the used signal, {lib_ms * 1e3:.2f} us, bound "
        f"{bnd[0] * 1e3:.2f} us by {bnd[1]}) [{card}]")
    rec = kv_record("paged_attention",
                    "src/repro_torch/kernels/csrc/paged_attention.cu",
                    "src/repro/kernels/paged_attention.py:83", ms, plain_ms,
                    lib_ms, err, bnd)
    rec["path"] = "mma"                # paged_attention's tensor-core path
    del kf, vf, kg, vg

    # ---- paged_attention at the other shapes the kernel takes: both
    # dtypes and both paths (the CUDA-core path for f32 and for bf16 pages
    # of 128 rows, with staged and unstaged pages: the unstaged variant
    # serves pages whose two buffers exceed 128 KB), one block per
    # (sequence, kv head) and pages split over blocks (40 x 4 pairs fill
    # an H100's SMs, 3 x 2 do not), granite-20b's 48 query heads over one
    # kv head and paligemma-3b's head_dim 256 on the tensor cores, and a
    # sequence with no valid row (0, not NaN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_single = 0
    for dt, Pp, Dd, Gg, Bs, KVs, path in (
            (torch.float32, 128, 256, 8, 3, 2, "cuda_core"),
            (bf16, 128, 256, 2, 3, 2, "cuda_core"),
            (torch.float32, 64, 128, 4, 3, 2, "cuda_core"),
            (bf16, 16, 64, 1, 3, 2, "mma"),
            (torch.float32, 64, 128, 4, 40, 4, "cuda_core"),
            (bf16, 64, 128, 4, 40, 4, "mma"),
            (bf16, 64, 128, 48, 2, 1, "mma"),
            (bf16, 64, 256, 8, 2, 1, "mma")):
        Hs, Fs, NPs = KVs * Gg, 12, 6
        check(tpattn.kernel_path(dt, dt, Gg, Dd, Pp) == path,
              f"paged_attention: {dt} P={Pp} Dh={Dd} G={Gg} would not take "
              f"the {path} path")
        n_single += tpattn.launch_plan(path, Bs * KVs, NPs, sms, Gg, Dd,
                                       Pp)[0] == 1
        kf = torch.randn((KVs, Fs, Pp, Dd), generator=g, device=dev, dtype=dt)
        vf = torch.randn((KVs, Fs, Pp, Dd), generator=g, device=dev, dtype=dt)
        qx = torch.randn((Bs, Hs, Dd), generator=g, device=dev, dtype=dt)
        tab = torch.stack([torch.randperm(Fs, generator=g, device=dev)[:NPs]
                           for _ in range(Bs)]).to(torch.int32)
        tab[-1] = -1
        tab[0, 2] = -1
        ln = torch.randint(0, Pp + 1, (Bs, NPs), generator=g, device=dev,
                           dtype=torch.int32)
        n_mma = tpattn.launches_mma
        o_k, u_k = ops.paged_attention(qx, kf, vf, tab, ln)
        check(tpattn.launches_mma - n_mma == (path == "mma"),
              f"paged_attention: {dt} P={Pp} Dh={Dd} G={Gg} did not run "
              f"on the {path} path")
        o_p, u_p = ref.paged_attention_ref(qx, kf, vf, tab, ln)
        border = used_borderline(torch, qx, kf, vf, tab, ln)
        name = f"paged_attention ({dt}, P={Pp}, Dh={Dd}, G={Gg})"
        check_attention(torch, name, o_k, u_k, o_p, u_p, border)
        check_repeat(torch, ops, name, o_k, u_k, (qx, kf, vf, tab, ln))
        check(not bool(o_k[-1].any()), "paged_attention: an empty sequence "
                                       "did not give 0")
    check(n_single == 2, f"paged_attention: {n_single} of the other shapes "
                         f"ran unsplit on {sms} SMs, not 2")
    log("[kernel] paged_attention also equal to plain, and the same bits "
        "on a repeat call, at f32 P=128 Dh=256 G=8, bf16 P=128 Dh=256 G=2 "
        "(CUDA cores, unstaged pages), f32 P=64 Dh=128 G=4, bf16 P=16 "
        "Dh=64 G=1 (3 sequences x 2 kv heads, split pages), f32 and bf16 "
        "P=64 Dh=128 G=4 (40 sequences x 4 kv heads, one block each), bf16 "
        "P=64 Dh=128 G=48 and Dh=256 G=8 (2 sequences x 1 kv head, tensor "
        "cores), with an empty sequence giving 0")
    del kf, vf

    # ---- paged_attention at granite-20b's and paligemma-3b's widths:
    # decode over 32 sequences of 32,768 tokens, one kv head
    for label, Gg, Dd in (("granite-20b G=48 Dh=128", 48, 128),
                          ("paligemma-3b G=8 Dh=256", 8, 256)):
        Bw, NPw = WIDE_BATCH, DENSE_PAGES
        Fw = Bw * NPw
        kf = torch.randn((1, Fw + 1, P, Dd), generator=g, device=dev,
                         dtype=bf16)
        vf = torch.randn((1, Fw + 1, P, Dd), generator=g, device=dev,
                         dtype=bf16)
        table = torch.arange(Fw, dtype=torch.int32, device=dev).view(Bw, NPw)
        lens = torch.full((Bw, NPw), P, dtype=torch.int32, device=dev)
        qw = torch.randn((Bw, Gg, Dd), generator=g, device=dev, dtype=bf16)
        n_mma = tpattn.launches_mma
        o_k, u_k = ops.paged_attention(qw, kf, vf, table, lens)
        check(tpattn.launches_mma == n_mma + 1,
              f"paged_attention ({label}): not on the tensor cores")
        sel = torch.tensor([0, Bw - 1], device=dev)
        o_p, u_p = ref.paged_attention_ref(qw[sel], kf, vf, table[sel],
                                           lens[sel])
        border = used_borderline(torch, qw[sel], kf, vf, table[sel],
                                 lens[sel])
        err_w, _, _ = check_attention(
            torch, f"paged_attention ({label}, sequences 0 and {Bw - 1})",
            o_k[sel], u_k[sel], o_p, u_p, border)
        ms_w = device_ms(torch, lambda: ops.paged_attention(
            qw, kf, vf, table, lens), n=10, rounds=3)
        kg = kf[:, :Fw].view(1, Bw, NPw * P, Dd).transpose(0, 1).contiguous()
        vg = vf[:, :Fw].view(1, Bw, NPw * P, Dd).transpose(0, 1).contiguous()
        lib_w = device_ms(torch, sdpa_fn(torch, qw, kg, vg), n=10, rounds=3)
        del kg, vg
        L = NPw * P
        nbytes = 2 * Bw * L * Dd * 2 + 2 * Bw * Gg * Dd * 2 + Bw * NPw * P \
            + 8 * Bw * NPw
        bnd_w = bound(nbytes, 4 * Gg * Dd * L * Bw, rate, PEAK_BF16)
        log(f"[kernel] paged_attention {label} (B={Bw} x {L} tokens, one kv "
            f"head, bf16): max abs err {err_w:.3g} on 2 sequences "
            f"(tolerance 2e-2 x the largest output); {ms_w * 1e3:.2f} us "
            f"(library scaled_dot_product_attention on K/V gathered "
            f"contiguous {lib_w * 1e3:.2f} us, bound {bnd_w[0] * 1e3:.2f} us "
            f"by {bnd_w[1]}) [{card}]")
        key = "g48" if Gg == 48 else "dh256"
        rec.update({f"{key}_ms": ms_w, f"{key}_library_ms": lib_w,
                    f"{key}_bound_ms": bnd_w[0], f"{key}_max_abs_err": err_w})
        del kf, vf
        torch.cuda.empty_cache()

    # ---- paged_attention, dense decode_32k: B=128, 512 pages each ---------
    B, NPd = DENSE_BATCH, DENSE_PAGES
    Fd = B * NPd
    kf = torch.empty((KVH, Fd + 1, P, Dh), device=dev, dtype=bf16)
    vf = torch.empty((KVH, Fd + 1, P, Dh), device=dev, dtype=bf16)
    for h in range(KVH):
        kf[h].normal_(generator=g)
        vf[h].normal_(generator=g)
    table = torch.arange(Fd, dtype=torch.int32, device=dev).view(B, NPd)
    lens = torch.full((B, NPd), P, dtype=torch.int32, device=dev)
    qd = torch.randn((B, H, Dh), generator=g, device=dev, dtype=bf16)
    n_mma = tpattn.launches_mma
    o_k, u_k = ops.paged_attention(qd, kf, vf, table, lens)
    check(tpattn.launches_mma == n_mma + 1,
          "paged_attention (dense): not launched on the tensor cores")
    # four sequences spread over the batch, so a fault in how blocks map to
    # sequences cannot hide past the first few
    sel = torch.tensor(DENSE_CHECKED, device=dev)
    o_p, u_p = ref.paged_attention_ref(qd[sel], kf, vf, table[sel],
                                       lens[sel])
    border = used_borderline(torch, qd[sel], kf, vf, table[sel], lens[sel])
    err_d, n_diff, n_border = check_attention(
        torch, f"paged_attention (dense, sequences {DENSE_CHECKED})",
        o_k[sel], u_k[sel], o_p, u_p, border)
    check_repeat(torch, ops, "paged_attention (dense)", o_k, u_k,
                 (qd, kf, vf, table, lens))
    ms_d = device_ms(torch, lambda: ops.paged_attention(qd, kf, vf, table,
                                                        lens), n=5, rounds=3)
    plain4_ms = device_ms(torch, lambda: ref.paged_attention_ref(
        qd[sel], kf, vf, table[sel], lens[sel]), n=3, rounds=3)
    kg = kf[:, :Fd].view(KVH, B, NPd * P, Dh).transpose(0, 1).contiguous()
    vg = vf[:, :Fd].view(KVH, B, NPd * P, Dh).transpose(0, 1).contiguous()
    lib_d = device_ms(torch, sdpa_fn(torch, qd, kg, vg), n=5, rounds=3)
    del kg, vg
    L = NPd * P
    nbytes = 2 * B * KVH * L * Dh * 2 + 2 * B * H * Dh * 2 + B * NPd * P \
        + 8 * B * NPd
    bnd_d = bound(nbytes, 4 * G * Dh * L * KVH * B, rate, PEAK_BF16)
    log(f"[kernel] paged_attention dense (decode_32k, B={B} x {L} tokens, "
        f"bf16): max abs err {err_d:.3g} on sequences {DENSE_CHECKED} "
        f"(tolerance 2e-2 x the largest output), the same bits on a repeat "
        f"call, "
        f"used differs on {n_diff} rows, {n_border} borderline; "
        f"{ms_d:.3f} ms (plain version on 4 of the 128 sequences "
        f"{plain4_ms:.3f} ms, library scaled_dot_product_attention on K/V "
        f"gathered contiguous {lib_d:.3f} ms, bound {bnd_d[0]:.3f} ms by "
        f"{bnd_d[1]}) [{card}]")
    rec.update(dense_ms=ms_d, dense_plain_ms_4_of_128=plain4_ms,
               dense_library_ms=lib_d, dense_bound_ms=bnd_d[0],
               dense_max_abs_err=err_d)
    out.append(rec)
    del kf, vf
    torch.cuda.empty_cache()

    # ---- cat_update: the hybrid plane's CAT, V=3,145,728, P=8, R=1024 ------
    V, Pc, R = CAT_PAGES, CAT_CARDS, CAT_TOUCHES
    bits = torch.randint(0, 2 ** Pc, (V, 1), generator=g, device=dev,
                         dtype=torch.int32)
    sets = []
    for _ in range(8):
        va = torch.randint(-1, V * Pc, (R,), generator=g, device=dev,
                           dtype=torch.int32)
        va[: R // 4] = va[R // 4: R // 2]            # duplicate touches
        sets.append(va)
    b_k, c_k = ops.cat_update(bits, sets[0], page_objs=Pc)
    b_p, c_p = ref.cat_update_ref(bits, sets[0], Pc)
    check(torch.equal(b_k, b_p) and torch.equal(c_k.view(torch.int32),
                                                c_p.view(torch.int32)),
          "cat_update: kernel disagrees with its plain version")
    pv = cyc(sets)
    ms = device_ms(torch, lambda: ops.cat_update(bits, pv(), page_objs=Pc))
    plain_ms = device_ms(torch, lambda: ref.cat_update_ref(bits, pv(), Pc),
                         n=10)
    bnd = bound(8 * V + 4 * V + 4 * R, 2 * R + 6 * V, rate, PEAK_F32)
    log(f"[kernel] cat_update V={V} P={Pc} R={R}: equal to plain, bits and "
        f"CAR bit for bit; {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
        f"library none, bound {bnd[0] * 1e3:.2f} us by {bnd[1]}) [{card}]")
    out.append(kv_record("cat_update",
                         "src/repro_torch/kernels/csrc/cat_update.cu",
                         "src/repro/kernels/cat_update.py:55", ms, plain_ms,
                         None, 0.0, bnd))
    del bits, sets
    torch.cuda.synchronize()
    return out


def _kv_states_equal(convert, cfg, a, b) -> bool:
    import numpy as np
    x, y = convert.kv_state_to_numpy(cfg, a), convert.kv_state_to_numpy(cfg, b)
    return all(np.array_equal(x[k], y[k]) for k in x)


def phase_kv_oracles(torch, tkv, convert) -> None:
    """Small-size oracles on the card: the batched fetch executor against
    the reference executor, bit for bit (outputs and every state field),
    through attend_sparse with each lookahead mode and through
    sharded_sparse_decode over two shards."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    for prefetch, frames in (("none", 5), ("sequential", 8),
                             ("majority", 8)):
        cfg = tkv.KVPlaneConfig(
            kv_heads=2, head_dim=8, page_tokens=4, num_pages=12,
            num_frames=frames, batch=2, sparse_topk=4, fetch_budget=2,
            car_threshold=0.5, dtype=torch.float32, prefetch=prefetch,
            prefetch_budget=0 if prefetch == "none" else 2)
        sb = tkv.init(cfg, dev)
        sb.k_slab.normal_(generator=g)
        sb.k_slab[:, 3, 2] = 4.0                  # magnet rows: skewed pages
        sb.k_slab[:, 12, 1] = -4.0
        sb.v_slab.normal_(generator=g)
        sb.kmax.copy_(sb.k_slab.amax(dim=2))
        sb.kmin.copy_(sb.k_slab.amin(dim=2))
        sr = sb.clone()
        lengths = torch.full((2,), 48, dtype=torch.int32, device=dev)
        for i in range(12):
            q = torch.randn((2, 4, 8), generator=g, device=dev) * (
                3.0 if i % 2 else 0.3)
            ob, _ = tkv.attend_sparse(cfg, sb, q, lengths, mode="batch")
            orr, _ = tkv.attend_sparse(cfg, sr, q, lengths, mode="reference")
            check(torch.equal(ob, orr), f"kv oracle ({prefetch}): outputs "
                                        f"differ at step {i}")
            check(_kv_states_equal(convert, cfg, sb, sr),
                  f"kv oracle ({prefetch}): states differ at step {i}")
        log(f"[kvoracle] attend_sparse prefetch={prefetch}: batch == "
            f"reference executor over 12 steps ({int((~sb.psf[:-1]).sum())} "
            f"pages on the runtime path)")
    # two shards of 4 pages of 8 tokens, two frames each; magnet rows on
    # pages 1 and 4 and alternating queries churn the frames, so magnet
    # pages flip to the runtime path and come back packed
    cfg = tkv.KVPlaneConfig(kv_heads=1, head_dim=16, page_tokens=8,
                            num_pages=4, num_frames=2, batch=1, sparse_topk=2,
                            fetch_budget=2, dtype=torch.float32)
    tb = [tkv.init(cfg, dev) for _ in range(2)]
    tr = [s.clone() for s in tb]
    keys = torch.randn((64, 1, 16), generator=g, device=dev) * 0.05
    keys[1 * 8 + 3] = 3.0
    keys[4 * 8 + 5] = -3.0
    vals = torch.randn((64, 1, 16), generator=g, device=dev)
    for t in range(64):
        lengths = torch.full((1,), t, dtype=torch.int32, device=dev)
        for st in (tb, tr):
            tkv.append_sharded(cfg, st, keys[t:t + 1], vals[t:t + 1], lengths)
    lengths = torch.full((1,), 64, dtype=torch.int32, device=dev)
    packed = 0
    for i in range(16):
        q = torch.full((1, 1, 16), 1.0 if i % 2 == 0 else -1.0, device=dev)
        ob, _ = tkv.sharded_sparse_decode(cfg, tb, q, lengths)
        orr, _ = tkv.sharded_sparse_decode(cfg, tr, q, lengths,
                                           mode="reference")
        check(torch.equal(ob, orr) and _kv_states_equal(convert, cfg, tb, tr),
              f"kv oracle (sharded): batch and reference differ at step {i}")
        packed += sum(int(((s.page_rows[:-1] > 0)
                           & (s.page_rows[:-1] < 8)).sum()) for s in tb)
    flips = sum(int((~s.psf[:-1]).sum()) for s in tb)
    log(f"[kvoracle] append_sharded + sharded_sparse_decode (D=2): batch == "
        f"reference executor over 64 appends and 16 decodes ({flips} pages "
        f"on the runtime path, {packed} packed residencies)")


def sparse_plane(torch, tkv, g):
    """llama3-8b's long_500k plane, one layer, filled directly: flat pages
    (keys 0.1 * N(0, 1)) and, on a quarter of the pages, one magnet row
    along a shared direction u that every query leans toward, so those
    pages' attention is skewed and their PSF can flip to runtime."""
    dev = g.device
    cfg = tkv.KVPlaneConfig(kv_heads=LLAMA_KV_HEADS, head_dim=LLAMA_HEAD_DIM,
                            page_tokens=PAGE_TOKENS, num_pages=SPARSE_PAGES,
                            num_frames=SPARSE_FRAMES, batch=1,
                            sparse_topk=SPARSE_TOPK,
                            fetch_budget=SPARSE_FETCH)
    s = tkv.init(cfg, dev)
    KVH, NP, P, Dh = cfg.kv_heads, cfg.num_pages, cfg.page_tokens, \
        cfg.head_dim
    u = torch.ones((Dh,), device=dev) / Dh ** 0.5
    for h in range(KVH):
        s.k_slab[h].normal_(generator=g).mul_(0.1)
        s.v_slab[h].normal_(generator=g)
    mag = torch.randperm(NP - 1, generator=g, device=dev)[:NP // 4]
    rows = torch.randint(0, P, (mag.shape[0],), generator=g, device=dev)
    s.k_slab[:, mag, rows] = (16.0 * u).to(cfg.dtype)
    s.kmax.copy_(s.k_slab.amax(dim=2).float())
    s.kmin.copy_(s.k_slab.amin(dim=2).float())
    qs = [(torch.randn((1, LLAMA_HEADS, Dh), generator=g, device=dev)
           + 4.0 * u).to(cfg.dtype) for _ in range(8)]
    lengths = torch.full((1,), NP * P, dtype=torch.int32, device=dev)
    return cfg, s, qs, lengths


def check_frames_hold_slab(torch, cfg, s) -> tuple[int, int]:
    """Every resident page's frame holds its slab rows: a paging page the
    whole page in order, a packed page its hot rows first, in hint order
    (the rest of the permuted page after them).  Returns (whole, packed)."""
    F = cfg.num_frames
    gp = s.frame_page[:F]
    res = gp >= 0
    g = gp.clamp_min(0).long()
    hot = s.hot_hint[g]
    packed = res & ~s.psf[g] & hot.any(dim=1)
    perm = torch.argsort((~hot).int(), dim=1, stable=True)
    ident = torch.arange(cfg.page_tokens, device=gp.device).expand_as(perm)
    perm = torch.where(packed[:, None], perm, ident)
    want = s.k_slab[:, g].gather(
        2, perm[None, :, :, None].expand(cfg.kv_heads, -1, -1,
                                         cfg.head_dim))
    have = s.k_frames[:, :F]
    same = (want == have).flatten(2).all(dim=2).all(dim=0)
    check(bool((same | ~res).all()),
          f"{int((~same & res).sum())} resident frames do not hold their "
          f"slab rows")
    rows = s.page_rows[g]
    check(bool(((rows == hot.sum(1)) | ~packed).all()),
          "a packed page's row count is not its hot-row count")
    return int((res & ~packed).sum()), int(packed.sum())


def phase_kv_sparse(torch, ops, ref, tkv, card: str):
    """The long_500k sparse hybrid decode: 128 steps of attend_sparse with
    8 cycling queries, both kernels launched every step and checked against
    their plain versions (on the inputs the step gave them) on the first 8
    steps and every 16th; then the frames, the PSF flips and the packed
    fetches.  Returns (cfg, state, queries, lengths, launch counts)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    t0 = time.time()
    cfg, s, qs, lengths = sparse_plane(torch, tkv, g)
    torch.cuda.synchronize()
    log(f"[kvsparse] llama3-8b long_500k plane, one layer: slab "
        f"{tuple(s.k_slab.shape)} bf16 x2 ({2 * s.k_slab.nbytes / 1e9:.2f} "
        f"GB), summaries {tuple(s.kmax.shape)} f32, frames "
        f"{tuple(s.k_frames.shape)} (one trash frame), top-{cfg.sparse_topk},"
        f" fetch budget {cfg.fetch_budget}; filled in {time.time() - t0:.1f}s")

    captured = {}
    capture = [False]
    orig_ps, orig_pa = ops.page_scores, ops.paged_attention

    def spy_ps(q, kmax, kmin, **kw):
        out = orig_ps(q, kmax, kmin, **kw)
        if capture[0]:
            captured["ps"] = (q.clone(), out.clone())
        return out

    def spy_pa(q, kf, vf, table, lens, **kw):
        out, used = orig_pa(q, kf, vf, table, lens, **kw)
        if capture[0]:
            captured["pa"] = tuple(x.clone() for x in
                                   (q, kf, vf, table, lens, out, used))
        return out, used

    checks = []
    host_ms, packed_seen = [], 0
    ops.page_scores, ops.paged_attention = spy_ps, spy_pa
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        for i in range(KV_STEPS):
            capture[0] = i < 8 or i % 16 == 15
            ts = time.perf_counter()
            out, _ = tkv.attend_sparse(cfg, s, qs[i % 8], lengths)
            if not capture[0]:
                host_ms.append((time.perf_counter() - ts) * 1e3)
            if capture[0]:
                checks.append((i, captured.pop("ps"), captured.pop("pa"),
                               out.clone()))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = ops.launch_counts()
    finally:
        ops.page_scores, ops.paged_attention = orig_ps, orig_pa
    check(bool(torch.isfinite(out).all()), "kvsparse: non-finite output")
    for k in ("page_scores", "paged_attention"):
        check(launches[k] == KV_STEPS,
              f"kvsparse: {k} launched {launches[k]} times in {KV_STEPS} "
              f"steps")
    check(launches["paged_attention_mma"] == launches["paged_attention"],
          f"kvsparse: {launches['paged_attention_mma']} of "
          f"{launches['paged_attention']} paged_attention launches on the "
          f"tensor cores")
    check(launches["gather_rows"] > 0, "kvsparse: no page-in gather")
    worst_ps = worst_pa = 0.0
    n_border = n_diff = 0
    for i, (q, sc_k), (qa, kf, vf, table, lens, o_k, u_k), out_i in checks:
        sc_p = ref.page_scores_ref(q, s.kmax, s.kmin)
        e = float((sc_k - sc_p).abs().max())
        check(e <= 1e-5 * float(sc_p.abs().max()),
              f"kvsparse step {i}: page_scores off by {e}")
        worst_ps = max(worst_ps, e)
        o_p, u_p = ref.paged_attention_ref(qa, kf, vf, table, lens)
        border = used_borderline(torch, qa, kf, vf, table, lens)
        e, nd, nb = check_attention(torch, f"kvsparse step {i} attention",
                                    o_k, u_k, o_p, u_p, border)
        check(torch.equal(o_k, out_i), "the step returned another output")
        worst_pa, n_diff, n_border = max(worst_pa, e), n_diff + nd, \
            n_border + nb
    whole, packed = check_frames_hold_slab(torch, cfg, s)
    flips = int((~s.psf[:-1]).sum())
    rows = s.page_rows[:-1]
    check(flips > 0, "kvsparse: no PSF flipped to runtime")
    check(packed > 0 or bool(((rows > 0) & (rows < cfg.page_tokens)).any()),
          "kvsparse: no packed (runtime-path) page resident")
    log(f"[kvsparse] {KV_STEPS} steps in {wall:.3f}s: {wall / KV_STEPS * 1e3:.3f}"
        f" ms per step with a sync at the end, host time per step p50 "
        f"{statistics.median(host_ms):.3f} ms [{card}]")
    log(f"[kvsparse] kernel launches {launches} ({KV_STEPS} steps)")
    log(f"[kvsparse] checked {len(checks)} steps against the plain versions: "
        f"page_scores max abs err {worst_ps:.3g} (tolerance 1e-5 x max "
        f"score), paged_attention max abs err {worst_pa:.3g} (tolerance "
        f"2e-2 x the largest output), used differs on {n_diff} rows, "
        f"{n_border} rows within "
        f"1e-5*mass of the threshold")
    log(f"[kvsparse] frames hold their slab rows: {whole} whole pages, "
        f"{packed} packed pages resident; {flips} pages flipped to the "
        f"runtime path")
    return cfg, s, qs, lengths, launches


def phase_kv_sparse_tail(torch, tkv, cfg, s, qs, lengths, card: str) -> None:
    """Where a sparse step's time goes (torch.profiler over 16 steps), then
    32 steps under set_sync_debug_mode("error")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(16):
            tkv.attend_sparse(cfg, s, qs[i % 8], lengths)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / 16
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)), e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows) / 1e6 / 16
    attn = [r for r in rows if "paged_attention" in r[2] or "combine" in r[2]]
    check(len(attn) == 1 and attn[0][1] == 16,
          f"kvsparse: paged_attention is not one kernel launch a step: "
          f"{[(r[2][:60], r[1]) for r in attn]}")
    n_ops = sum(r[1] for r in rows) / 16
    log(f"[kvsparse] profile over 16 steps: wall {wall * 1e3:.3f} ms/step, "
        f"device busy {busy * 1e3:.3f} ms/step ({100 * busy / wall:.1f}% of "
        f"wall), {n_ops:.0f} device ops/step [{card}]")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"[kvsparse]   {dev_us / 1e3 / 16:8.4f} ms/step "
            f"{count / 16:6.1f} per step  {key[:80]}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(KV_NOSYNC):
            out, _ = tkv.attend_sparse(cfg, s, qs[i % 8], lengths)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(out).all()), "kvsparse: non-finite output")
    log(f"[kvsparse] {KV_NOSYNC} more steps under set_sync_debug_mode"
        f"('error'): no host sync")


def phase_kv_dense(torch, ops, ref, tkv, card: str) -> dict:
    """llama3-8b's decode_32k plane, one layer (B=128, 512 pages of 64
    tokens each, 65,536 frames), frames filled directly: 8 steps of
    append_dense + attend_dense, each checked against an f32 recomputation
    from the frames on 4 sequences."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    B, NP, P = DENSE_BATCH, DENSE_PAGES, PAGE_TOKENS
    cfg = tkv.KVPlaneConfig(kv_heads=LLAMA_KV_HEADS, head_dim=LLAMA_HEAD_DIM,
                            page_tokens=P, num_pages=NP, num_frames=B * NP,
                            batch=B)
    t0 = time.time()
    s = tkv.init(cfg, dev)
    for h in range(cfg.kv_heads):
        s.k_frames[h].normal_(generator=g)
        s.v_frames[h].normal_(generator=g)
    lengths = torch.full((B,), NP * P - DENSE_STEPS, dtype=torch.int32,
                         device=dev)
    torch.cuda.synchronize()
    log(f"[kvdense] llama3-8b decode_32k plane, one layer: frames "
        f"{tuple(s.k_frames.shape)} bf16 x2 ({2 * s.k_frames.nbytes / 1e9:.1f}"
        f" GB), filled in {time.time() - t0:.1f}s")
    H, Dh = LLAMA_HEADS, cfg.head_dim
    table = s.page_table[:-1].view(B, NP)
    ops.reset_launch_counts()
    step_ms, worst = [], 0.0
    for i in range(DENSE_STEPS):
        kn = torch.randn((B, cfg.kv_heads, Dh), generator=g, device=dev,
                         dtype=cfg.dtype)
        vn = torch.randn((B, cfg.kv_heads, Dh), generator=g, device=dev,
                         dtype=cfg.dtype)
        q = torch.randn((B, H, Dh), generator=g, device=dev, dtype=cfg.dtype)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        tkv.append_dense(cfg, s, kn, vn, lengths)
        lengths = lengths + 1
        out, _ = tkv.attend_dense(cfg, s, q, lengths)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        lens = ops.lengths_to_page_lens(lengths[:4], NP, P)
        want, _ = ref.paged_attention_ref(q[:4], s.k_frames, s.v_frames,
                                          table[:4], lens)
        err = float((out[:4].float() - want.float()).abs().max())
        tol = attention_tol(torch, want)
        check(err <= tol, f"kvdense step {i}: output off by {err} "
                          f"(tolerance {tol:.3g})")
        worst = max(worst, err)
    launches = ops.launch_counts()
    check(launches["paged_attention"] == DENSE_STEPS,
          f"kvdense: paged_attention launched {launches['paged_attention']} "
          f"times in {DENSE_STEPS} steps")
    check(launches["paged_attention_mma"] == launches["paged_attention"],
          f"kvdense: {launches['paged_attention_mma']} of "
          f"{launches['paged_attention']} paged_attention launches on the "
          f"tensor cores")
    check(bool(s.psf[:-1].all()) and bool(s.cat[:-1].all()),
          "kvdense: a page left the paging path or a card stayed unmarked")
    log(f"[kvdense] {DENSE_STEPS} steps of append_dense + attend_dense: "
        f"{statistics.median(step_ms):.3f} ms per step (median, synced; "
        f"first {step_ms[0]:.3f} ms); output vs an f32 recomputation from the "
        f"frames on 4 sequences max abs err {worst:.3g} (tolerance 2e-2 x "
        f"the largest output); launches {launches} [{card}]")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import batch, kvplane, plane, state
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
    for k in ("gather_rows", "compact_pages", "cat_decay"):
        check(launches[k] > 0, f"serve: kernel {k} was never launched")
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

    # ---- the KV serve plane at llama3-8b's widths --------------------------
    del eng, s, data, data_t, ids_all, wl
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels += phase_kv_kernels(torch, ops, ref, card, rate)
    phase_kv_oracles(torch, kvplane, convert)
    kcfg, ks, qs, lengths, kv_launches = phase_kv_sparse(torch, ops, ref,
                                                         kvplane, card)
    phase_kv_sparse_tail(torch, kvplane, kcfg, ks, qs, lengths, card)
    del ks
    torch.cuda.empty_cache()
    dense_launches = phase_kv_dense(torch, ops, ref, kvplane, card)
    torch.cuda.empty_cache()
    for k in kernels:
        if k["name"] in ("page_scores", "paged_attention", "cat_update"):
            # cat_update is on no runtime path, in the JAX package either
            k["launches"] = kv_launches[k["name"]]
            k["launches_per_step"] = kv_launches[k["name"]] / KV_STEPS
        else:
            k["launches_per_step"] = k["launches"] / SERVE_TICKS
    pa = next(k for k in kernels if k["name"] == "paged_attention")
    pa["dense_launches_per_step"] = (dense_launches["paged_attention"]
                                     / DENSE_STEPS)
    pa["launches_mma"] = kv_launches["paged_attention_mma"]

    log(f"[done] {time.time() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
