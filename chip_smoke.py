#!/usr/bin/env python3
"""Drive the PyTorch port of the hybrid far-memory plane on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown of
                                     # one evacuation and one epoch

Phases (any failure exits non-zero, with no result line):

 1. device    the card's name and power limit (nvidia-smi)
 2. build     the CUDA kernels, compiled from src/repro_torch/kernels/csrc
 3. kernels   each CUDA kernel against its plain PyTorch version on the
              card, at the shapes the serving path gives it, with times;
              the per-launch floor (an empty kernel timed the same way)
    rowcopy   the row-copy kernels' regimes against their plain versions
              bit for bit: unaligned widths (4- and 1-byte words), 1 MB rows
              through the tiles regime with masked rows, all-masked index
              sets, R = 0; gather_rows at the KV page-in's 16 KiB rows timed
              beside index_select; gather_rows_into at the
              object-ingress shape, trash row included, timed beside
              index_select + index_put_
 4. oracles   at 512 objects: the batched executor against the scalar
              reference executor, bit for bit, on mcd_cl and df_scan traffic
              with evacuations and epochs; a pipelined engine against a
              sync engine
 5. serve     8,388,608 objects through the launcher's plane recipe and the
              pipelined engine, 256 ticks of mcd_cl at batch 1024; every
              served row checked on the card against the data; the engine
              (which replays its plan and execute, evacuation round and
              epoch from captured CUDA graphs) held bit for bit, rows and
              state, and launch for launch against the plain plane calls
              on a clone; a profile
              of 16 ticks (device operations per tick)
 6. no sync   50 more ticks of plan/execute/evacuate/epoch under
              torch.cuda.set_sync_debug_mode("error")
 7. writes    update, read back; writeback + evict everything, read again
 8. invariants of the final full-size state
    paging    the paging plane (Fastswap analogue), then
    object    the object plane (AIFM analogue), each as in 5 (same data,
              ticks and checks) under set_sync_debug_mode("error"), the
              object plane's reclaim reads alone excepted and counted;
              launches and device operations per tick; the paging engine
              (replayed from a graph) against plain calls, as in 5
    reclaim   the object plane at 65,536 objects until 1,000 objects are
              evicted, full LRU scan and a 4,096-object window: batch ==
              reference executor on a clone, every row and field, and the
              card's state == a CPU run of the same ticks; time per
              reclaim round
    robust    the hybrid engine at full size (as 5) through fig_faults'
              scenarios, dispatch="sync": fault-free, 20% failures with
              retries (and its same-seed replay: identical counters), a
              total outage with the circuit breaker; every served row
              checked, every offered request served or shed exactly once,
              the breaker trips and closes; p99 beside the fault-free p99
    shard     the store of 5 over 4 shards on the card (core.shardplane's
              loop oracle through the pipelined engine, 256 requests a
              shard): 256 ticks of mcd_cl with every row checked, every
              shard's invariants, thresholds in lockstep; 32 ticks of the
              serial schedule on clones == the overlap schedule, rows and
              state; a budget of 64 (4 rounds) on uniform traffic spills
              and serves every row; the paging and object planes sharded,
              64 ticks each, rows checked; 50 ticks under
              set_sync_debug_mode("error"); a 16-tick profile; at 512
              objects the reference executor == the batched one == the
              batched one on the CPU, bit for bit, on each plane
    shardrobust the sharded hybrid engine, dispatch="sync", with the
              per-shard breaker and an outage of shard 2, beside a
              fault-free twin: only shard 2's breaker trips and it closes,
              the healthy shards' rows and states are the twin's, every
              served row is right, every offered request is served or
              shed once; launches counted on the faulty engine alone
    shardmesh the mesh path over an NCCL group of the visible cards (one
              card: this process, world size 1, one shard; N cards: N
              spawned ranks): access/update/advance_epoch/evacuate through
              the group == the loop oracle (== the plain plane at one
              shard), phase_probe ("pack", "ingress") through the group ==
              the loop oracle's checksums with its device time a call, and
              jitted_sharded_decode on llama3-8b long_500k shards == the
              loop decode; launches counted on the calls through the group
              alone; with one card it says that the exchange across cards
              was not measured
 9. kernels   page_scores, paged_attention (the long_500k sparse step and
              the decode_32k batch; the other shapes either path takes;
              granite-20b's and paligemma-3b's widths) and cat_update
              against their plain versions at llama3-8b's widths, with
              times, bounds and the library call where there is one; every
              bf16 paged_attention call on the tensor cores, and a repeat
              call the same bits; cat_update bit for bit at the hybrid
              plane's CAT and in 11 cases around it (touches past the end,
              none, 65,536, views off 16 bytes, 2 words a page, every
              page touched, pages of 3,000 and 8,192 words; pages split
              over blocks: one of 65,536 words, 4 of 8,193 touched in
              every block, one of 8,200 with -1 and past-the-end
              touches), one launch a call (two for split pages: the
              counters' fill), timed cold (copies of the words cycled)
              and warm
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
13. lm        llama3-8b at full width and depth (32 layers, bf16, weights
              from a seeded generator) through models.api.decode_step,
              replayed from one captured CUDA graph after its first step:
              8 sequences, 2,048 seeded tokens of context in the dense KV
              plane, 32 timed greedy steps (paged_attention 32 launches a
              step, lengths 2,080 after), 8 steps each also through the
              plain path on a clone (logits within 5e-2 of the largest),
              a 4-step profile, 8 steps with no host sync; paged_attention
              at the step's shape against its plain version and SDPA
14. lmexpert  kimi-k2 at full width, one layer deep, through the expert
              plane (384 experts, 32 hot slots, fetch budget 8): as 13,
              plus gather_rows 3 launches a step (all gather_rows_into),
              every resident slot equal to its expert's slab rows, batch ==
              reference executor on a clone, paged_attention at head_dim
              112, gather_rows at the expert fetch's 29.36 MB rows
              against index_select, gather_rows_into
              there against its plain version, the whole fetch's device
              time
15. lmmoe    mixtral-8x7b at full width, 16 of its 32 layers (the depth cut:
              32 layers of bf16 weights take ~93 GB), through the dropping
              MoE: as 13 (16 paged_attention launches a step), each
              sequence's logits against the plain path unless its routing
              parted at a near-tie (bf16 router logits tie exactly often);
              then decode_long through the window plane (a ring of 64
              pages), one sequence from 4,088 tokens across the wrap
16. lmssm     xlstm-350m at full width and depth, batch 128 (6.48 GB of
              recurrent state), no kernel on the path: 16 timed steps, then
              2 sequences 4 more steps on the card and on the CPU from the
              same weights and state, in f32 (within 1e-4) and in bf16
              (the card no further from the f32 answer than twice the
              CPU's bf16); profile, no host sync
17. lmhybrid  zamba2-1.2b at full width and depth: decode as 13 (6
              paged_attention launches a step, G = 1, head_dim 64), then
              long_500k, one sequence from 524,224 tokens through 6 sparse
              planes filled as in 11 (6 page_scores and 12 gather_rows a
              step; the LM sparse step attends with plain code, as in JAX);
              page_scores at zamba2's summaries
18. lmencdec  seamless-m4t-medium at full width, a seeded encoder memory of
              1,024 positions: as 13 (12 launches a step, pages split)
Every paged_attention launch of 11 to 18 is on the tensor cores.
19. trainattn chunked_attention forward and backward at llama3-8b's head
              shapes (4,096 positions, chunks of 512; causal and a 1,024
              window) against full_attention on the card (out, dq, dk, dv
              within 1e-4 of the largest); fwd+bwd timed beside
              scaled_dot_product_attention (not on the path)
20. trainblock one llama3-8b block at full width over 512 positions,
              forward and backward on the card and on the CPU from the
              same parameters: output and every gradient within 1e-4
21. trainfam  each of the 10 archs' smoke configs: the loss and every
              gradient, then one make_train_step (AdamW; Adafactor for
              kimi) on the card and on the CPU from the same parameters
              and batch (the dropping MoE under remat, mLSTM/sLSTM, Mamba2,
              the vision prefix, the encoder-decoder under autograd)
22. train     llama3-8b at full width, 4 of its 32 layers, f32 (as the
              launcher trains), batch 2 x 4,096 in 2 micro-batches: 8
              timed steps and one profiled (ms/step, tokens/s, peak
              memory, device operations and busy share, the FLOP bound),
              then the same 8 steps through the orchestrator with async
              checkpoints every 4 steps and a failure at step 5:
              restarts=1, the resumed losses equal the uninterrupted run's
23. prefill   the same model's prefill step (2 x 64 tokens) against the
              64th logits of decode_step token by token through the dense
              KV plane (paged_attention, 4 launches a token)
24. meshlayout the model-mesh layout executed on the card: llama3-8b at
              full width, 2 of its 32 layers, f32, batch 2 x 2,048, one
              plain train step and one on parameters, AdamW state and
              batch laid out from their logical specs on a (1, 1)
              ("data", "model") mesh over an NCCL group of one rank, shard
              active: loss, gnorm and every updated parameter within 1e-5
              of the largest; ms per step of each; ckpt.restore(mesh=,
              spec_tree=param_pspecs) of those parameters bit for bit with
              the resolved placements
25. meshdecode the serve step on a model mesh on the card: llama3-8b at
              full width, 8 of its 32 layers, bf16, parameters on a (1, 1)
              ("data", "model") mesh of an NCCL group of one rank and the
              serve state laid out by api.serve_state_on_mesh; dense
              decode (as 13: 8 sequences, 2,048 seeded tokens of context)
              and long_500k through the sparse plane at shards = dp = 1;
              kimi-k2 at full width, 1 of 61 layers, through the expert
              plane (as 14, the 33.8 GB slab shared by both paths); 8
              greedy steps each on the mesh and on the plain path from
              the same state: logits within 1e-5 of the largest, every
              int and bool KV and expert plane field bit for bit after
              api.serve_state_whole, kernel launches equal (8
              paged_attention a dense llama3-8b step; 8 page_scores and
              16 gather_rows a long step; 1 paged_attention and 3
              gather_rows a kimi-k2 step); ms a step both ways
26. dryrun    launch.dryrun.run_cell on fake cuda meshes at full width, 2
              layers: llama3-8b train_4k on 16 x 16 (256 fake ranks) and
              2 x 16 x 16 (512), prefill_32k, decode_32k and long_500k on
              16 x 16, kimi-k2 decode_32k on 16 x 16: argument bytes a
              device (llama3-8b's against the arithmetic), FLOPs a device
              beside the analytic model's, collectives by kind,
              MemTracker's peak, the trace's seconds; gradient sync in the
              train cells, the sparse combine's all-gathers in long_500k;
              in kimi-k2's no all-gather of the hot store and two
              all-reduces a layer of its products' partial sums over dp

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA GPU and the repository's
sources beside this file; it never runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# the object plane's reclaim run: the launcher's recipe cut to 65,536
# objects (2,048 frames, filled after ~160 ticks of mcd_cl), run until at
# least 1,000 objects were evicted; the windowed LRU scans 4,096 objects
RECLAIM_OBJECTS, RECLAIM_MIN, RECLAIM_BUDGET = 65_536, 1000, 4096
RECLAIM_MAX_TICKS = 240
# the robust engine's runs (fig_faults' scenarios): ticks per run
ROBUST_TICKS = 120
# the sharded far tier ([shard], [shardrobust]): the store over 4 shards on
# one card (R = 256 requests a shard), the serve run, the serial schedule
# on clones, a budget of 64 ids (4 rounds), the paging and object planes;
# the robust run's ticks and the shard its outage hits; [shardmesh]: ticks
# and KV decode steps through the group, and a spawned rank's time limit
SHARDS, SHARD_TICKS, SHARD_SERIAL_TICKS = 4, 256, 32
SHARD_SPILL_TICKS, SHARD_SPILL_BUDGET, SHARD_PLANE_TICKS = 32, 64, 64
SHARD_ROBUST_TICKS, SHARD_OUTAGE = 96, 2
MESH_TICKS, MESH_KV_STEPS, MESH_TIMEOUT_S = 32, 8, 600
# cat_update at the hybrid plane's CAT: 3,145,728 pages of 8 cards, 1,024
# touches; the cases beside it: touches up to 3 pages past the end, none,
# 65,536, views off 16 bytes, 40 cards a page (2 words) over half the
# pages, 65,536 touches on 1,024 pages (every page touched), pages of
# 3,000 and 8,192 words (chunks of 2 pages and of 1, the widest page one
# block takes), and pages split over blocks (pages, cards): one of 65,536
# words (8 blocks), 4 of 8,193 (2 blocks each, the second one word wide),
# and one of 8,200 words with 3 cards short of its last word; 4 copies of
# the words, cycled, time it cold in L2
CAT_PAGES, CAT_CARDS, CAT_TOUCHES = 3_145_728, 8, 1024
CAT_WIDE_CARDS, CAT_MANY, CAT_SMALL_PAGES, CAT_COLD = 40, 65_536, 1024, 4
CAT_HUGE_CARDS = (3000 * 32, 8192 * 32)
CAT_SPLIT = ((1, 65_536 * 32), (4, 8193 * 32), (1, 8200 * 32 - 3))
# the model decode path ([lm], [lmexpert]): 8 sequences in a 4,096-token
# dense KV plane with 2,048 seeded tokens of context, 32 timed greedy
# steps, 8 more each checked against the plain path, a 4-step profile and
# 8 steps under set_sync_debug_mode("error")
LM_BATCH, LM_SEQ, LM_PREFIX = 8, 4096, 2048
LM_STEPS, LM_CHECKED, LM_PROFILE, LM_NOSYNC = 32, 8, 4, 8
# logits of the kernel path against the plain path, relative to the largest
# |logit|: the attention kernel and its plain version round apart by a few
# bf16 ulps in each layer (2e-2 of the largest output is that kernel's own
# limit), and 32 layers carry it to the logits
LM_LOGIT_TOL = 5e-2
# a routed token whose k-th and (k+1)-th router probabilities lie closer
# than this (relative) may change experts between the two paths: one
# attention layer before the router (kimi-k2's one layer), or the
# attention kernel's own limit (2e-2 of its largest output) carried into
# the router of a deep dropping MoE (mixtral)
ROUTE_TIE, MOE_ROUTE_TIE = 1e-3, 2e-2
# the rest of model decode ([lmmoe], [lmssm], [lmhybrid], [lmencdec]):
# timed greedy steps, steps checked against the plain path (or, in [lmssm],
# the CPU), steps under set_sync_debug_mode("error"); mixtral's depth cut;
# its window run (timed steps from 4,088 tokens, then checked steps across
# the wrap at 4,096); xlstm's batch (decode_32k's) and its CPU check;
# zamba2's long_500k start (the last page of 8,192); seamless's encoder
# memory length
REST_STEPS, REST_CHECKED, REST_NOSYNC, MOE_CHECKED = 16, 4, 4, 8
MOE_LAYERS = 16
WINDOW_FROM, WINDOW_TIMED, WINDOW_CHECKED = 4088, 4, 8
SSM_BATCH, SSM_CPU_SEQS, SSM_CPU_STEPS = 128, 2, 4
# [lmssm]'s f32 logits on the card against the CPU's, relative to the
# largest (the CPU tests' f32 tolerance)
SSM_F32_TOL = 1e-4
LONG_SEQ, LONG_FROM = 524_288, 524_224
ENC_LEN = 1024
# the training path: [trainattn] chunked_attention at llama3-8b's head
# shapes (one sequence of 4,096, chunks of 512, causal and a 1,024 window);
# [trainblock] one llama3-8b block over 512 positions, the card against the
# CPU; [trainfam] one train step of each arch's smoke config (48 positions,
# 2 sequences, a constant lr of 1e-3), the card against the CPU (at 64
# positions a chunk of xlstm's smoke recurrence sums its decays past 88,
# exp overflows under the causal mask and the gradient, 0 x inf, is NaN in
# the JAX package as in the port); [train]
# llama3-8b at full width cut to 4 of its 32 layers (params and AdamW's
# moments take 16 bytes a parameter: 30.8 GB at 4 layers), f32 as the
# launcher trains, train_4k's 4,096 positions, batch 2 in 2 micro-batches,
# 8 steps through the orchestrator with a checkpoint every 4 and a failure
# at step 5; [prefill] the same model, 2 sequences of 64 tokens
ATTN_SEQ, ATTN_CHUNK, ATTN_WINDOW = 4096, 512, 1024
BLOCK_SEQ = 512
FAM_SEQ, FAM_BATCH, FAM_LR = 48, 2, 1e-3
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 4, 4096, 2, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 5
PREFILL_BATCH, PREFILL_TOKENS = 2, 64
# f32 on the card against f32 elsewhere (the CPU, the unchunked attention),
# relative to the largest |value| of each tensor: outputs, gradients and
# updated parameters; a smoke model's gradients (zamba2's 38 layers move
# by up to 3.3e-4 of the largest under one ulp of parameter noise) and
# gnorm; the loss (relative); a resumed run's losses (relative); the
# prefill against token-by-token decode (rtol and atol, the tolerance
# tests/test_models.py holds JAX's decode to)
TRAIN_TOL, FAM_GRAD_TOL, FAM_LOSS_TOL = 1e-4, 1e-3, 1e-4
RESUME_RTOL, PREFILL_TOL = 1e-5, 3e-3
# AdamW's first step is lr x g / (|g| + eps) after clipping: lr x sign(g),
# except near g = 0, where the slope is 1/eps and a sign flip moves the
# update by 2 lr.  There a rounding of g moves the update by up to lr.  So
# the updated parameters' check leaves out (and counts) the elements whose
# gradient the card and the CPU agree on to less than this, relative to
# the element's own |gradient|; for the rest a gradient error of e moves
# the update by at most lr x e / 4 (every gradient is checked itself)
FAM_GRAD_AGREE = 1e-3
# the model-mesh layout: [meshlayout] llama3-8b at full width cut to 2 of
# its 32 layers, f32, batch 2 x 2,048, one plain train step and one laid
# out on a (1, 1) ("data", "model") mesh over an NCCL group of one rank
# (one card: NCCL takes a card a rank), from step 10 (the schedule's lr is
# 0 at step 0); the two steps' loss, gnorm and updated parameters within
# 1e-5 of the largest; [dryrun] the port's dry-run of three cells at full
# width, 2 of 32 layers, as rank 0 of a fake process group of 256 ranks
# (16 x 16) or 512 (2 x 16 x 16)
LAYOUT_LAYERS, LAYOUT_SEQ, LAYOUT_BATCH, LAYOUT_STEP = 2, 2048, 2, 10
LAYOUT_TOL = 1e-5
# [meshdecode]: llama3-8b at full width cut to 8 of its 32 layers, bf16, the
# serve step on a (1, 1) mesh of an NCCL group of one rank against the
# plain step from the same state: dense decode as [lm] (8 sequences, 2,048
# tokens of context in a 4,096-token plane) and long_500k through the
# sparse plane at shards = dp = 1 from LONG_FROM tokens, MESHDEC_STEPS
# greedy steps each way; logits within LAYOUT_TOL of the largest
MESHDEC_LAYERS, MESHDEC_STEPS = 8, 8
DRYRUN_LAYERS = 2
DRYRUN_CELLS = (("llama3-8b", "train_4k", "single"),
                ("llama3-8b", "train_4k", "multi"),
                ("llama3-8b", "prefill_32k", "single"),
                ("llama3-8b", "decode_32k", "single"),
                ("llama3-8b", "long_500k", "single"),
                ("kimi-k2-1t-a32b", "decode_32k", "single"))


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
    import numpy
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"numpy {numpy.__version__} devices={torch.cuda.device_count()}")
    return name, card


def phase_build(build) -> None:
    t0 = time.time()
    so = build.build()
    build.load_library()
    log(f"[build] {so.name} in {time.time() - t0:.1f}s "
        f"(nvcc {build.build_seconds:.1f}s)")
    for line in build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("---")):
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
    check(torch.equal(ops.gather_rows(page_rows, psets[0]),
                      ref.gather_rows_ref(page_rows, psets[0])),
          "gather_rows on 1 KiB page rows: kernel disagrees with its plain "
          "version")
    check(torch.equal(ops.gather_pages(state.slab[None], psets[0]),
                      ops.gather_pages(state.slab[None], psets[0],
                                       impl="ref")),
          "gather_pages: kernel disagrees with its plain version")
    pb = pvalid * page_b + (BATCH + Q) * page_b + (BATCH + Q) * 4
    log(f"[kernel] gather_rows on 1 KiB page rows (gather_pages, R+Q="
        f"{BATCH + Q}, plan {plan_of(page_rows, psets[0])}): equal to plain "
        f"(tolerance 0); {k_ms * 1e3:.2f} us (plain {p_ms * 1e3:.2f} us, "
        f"library index_select {l_ms * 1e3:.2f} us, whole gather_pages "
        f"wrapper {w_ms * 1e3:.2f} us, bound {pb / rate * 1e6:.3f} us by "
        f"{pb:.0f} B) [{card}]")
    page_shape = dict(rows=BATCH + Q, row_bytes=page_b, ms=k_ms,
                      plain_ms=p_ms, library_ms=l_ms, bound_ms=pb / rate * 1e3,
                      gather_pages_ms=w_ms, max_abs_err=0.0)

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

    # the per-launch floor: an empty kernel (torch.cuda._sleep(0)) timed
    # the same way, back to back on the device
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    gr, cp = results[0], results[1]
    for r in (gr, cp):
        r["launch_floor_ms"] = floor_ms
    log(f"[kernel] launch floor, an empty kernel (torch.cuda._sleep(0)) back "
        f"to back: {floor_ms * 1e3:.2f} us; beside it gather_rows "
        f"{gr['ms'] * 1e3:.2f} us (index_select {gr['library_ms'] * 1e3:.2f} "
        f"us), compact_pages {cp['ms'] * 1e3:.2f} us (index_select "
        f"{cp['library_ms'] * 1e3:.2f} us) [{card}]")

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
    results[0]["shapes"] = {"page_rows_1k": page_shape}
    return results


def cycler(items):
    """Each call the next input set: the serving path finds its rows cold
    in L2, so the timed calls do not reuse one index set."""
    pos = [0]

    def nxt():
        pos[0] += 1
        return items[pos[0] % len(items)]
    return nxt


def dst_pool_idx(d_i, pool):
    """(dst_idx, pool, idx) for gather_rows_into from a (dst_idx, idx)
    pair."""
    return d_i[0], pool, d_i[1]


def plan_of(pool, idx) -> str:
    """The row-copy launch plan the gather_rows wrapper takes for these
    tensors, in short."""
    from repro_torch.kernels import gather_objects as gmod
    rb = pool.shape[1] * pool.element_size()
    p = gmod.launch_plan(max(idx.shape[0], 1), rb,
                         word=gmod.word_bytes(rb, pool.data_ptr()))
    return (f"{p.regime}, {p.word_bytes} B words, {p.lanes} lanes a row, "
            f"grid {p.grid_x} x {p.grid_y}"
            f"{', streaming' if p.streaming else ''}")


def phase_row_copy(torch, ops, ref, gmod, state, card: str,
                   rate: float) -> dict:
    """The row-copy kernels' regimes against their plain versions, bit for
    bit, at the shapes they meet beyond phase_kernels': unaligned widths
    (4-byte and 1-byte words), long rows through the tiles regime with
    masked rows and a ragged last tile, all-masked index sets, R = 0; and
    gather_rows_into at the object-ingress shape, trash row included.
    Returns the timed shapes for the kernels' JSON line."""
    dev = state.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 11)
    shapes = {}

    def idx_for(r, hi, p_masked):
        i = torch.randint(0, hi, (r,), generator=g, device=dev,
                          dtype=torch.int32)
        drop = torch.rand((r,), generator=g, device=dev) < p_masked
        return torch.where(drop, -1, i)

    def same(tag, got, want):
        check(got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
              f"[rowcopy] {tag}: kernel disagrees with its plain version")

    def bytes_of(pool, idx):
        rb = pool.shape[1] * pool.element_size()
        return int((idx >= 0).sum()) * rb + idx.shape[0] * (rb + 4)

    # unaligned and odd widths, each regime and word
    cases = []
    raw = torch.randint(0, 256, (64 * 1024 * 1024 + 64,), generator=g,
                        device=dev, dtype=torch.uint8)
    cases.append(("132 B rows (f32 x 33, 4-byte words)",
                  raw[:65536 * 132].view(torch.float32).view(65536, 33),
                  idx_for(BATCH, 65536, 0.25)))
    cases.append(("130 B rows (bf16 x 65, 1-byte words)",
                  raw[:65536 * 130].view(torch.bfloat16).view(65536, 65),
                  idx_for(BATCH, 65536, 0.25)))
    cases.append(("128 B rows at a pointer 2 B off 16 (1-byte words)",
                  raw[2:2 + 65536 * 128].view(65536, 128),
                  idx_for(BATCH, 65536, 0.25)))
    cases.append(("4,098 B rows (tiles regime, 1-byte words)",
                  raw[:4096 * 4098].view(4096, 4098), idx_for(64, 4096, 0.25)))
    long_pool = raw[:64 * 1_000_016].view(64, 1_000_016)
    long_idx = idx_for(16, 64, 0.3)
    long_idx[0] = -1
    cases.append(("1,000,016 B rows, masked rows, ragged last tile",
                  long_pool, long_idx))
    cases.append(("all-masked 128 B rows", raw[:65536 * 128].view(65536, 128),
                  torch.full((BATCH,), -1, dtype=torch.int32, device=dev)))
    cases.append(("all-masked 1,000,016 B rows", long_pool,
                  torch.full((8,), -1, dtype=torch.int32, device=dev)))
    for tag, pool, idx in cases:
        got = gmod.gather_rows(pool, idx)
        same(tag, got, ref.gather_rows_ref(pool, idx))
        log(f"[rowcopy] {tag}, R={idx.shape[0]} (plan "
            f"{plan_of(pool, idx)}): equal to plain, bit for bit")
    # compact_pages at an unaligned width, and R = 0 on every entry point
    cp_pool = cases[1][1]
    cp_plan = idx_for(4 * 8, cp_pool.shape[0], 0.25)
    same("compact_pages, 130 B rows",
         ops.compact_pages(cp_pool, cp_plan, page_objs=8),
         ref.compact_pages_ref(cp_pool, cp_plan, 8))
    n0 = ops.launch_counts()
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    same("R = 0", ops.gather_rows(cp_pool, empty),
         ref.gather_rows_ref(cp_pool, empty))
    same("R = 0 (compact_pages)", ops.compact_pages(cp_pool, empty,
                                                    page_objs=8),
         ref.compact_pages_ref(cp_pool, empty, 8))
    before = cp_pool.clone()
    ops.gather_rows_into(cp_pool, empty, torch.ones(
        (4, 65), dtype=torch.bfloat16, device=dev), empty)
    same("R = 0 (gather_rows_into)", cp_pool, before)
    check(ops.launch_counts() == n0, "[rowcopy] R = 0 launched a kernel")
    log("[rowcopy] compact_pages at 130 B rows equal to plain; R = 0: "
        "gather_rows, compact_pages and gather_rows_into launch nothing")
    del raw, cases, long_pool, before

    # gather_rows at the KV page-in's shape (gather_pages on long_500k):
    # SPARSE_FETCH pages of each of the kv heads, one 16 KiB bf16 page row
    # each, from a 256 MiB slab view
    kv = torch.randn((16_384, PAGE_TOKENS * LLAMA_HEAD_DIM), generator=g,
                     device=dev, dtype=torch.bfloat16)
    R = SPARSE_FETCH * LLAMA_KV_HEADS
    ksets = [idx_for(R, kv.shape[0], 0.0) for _ in range(16)]
    same("16 KiB KV page rows", ops.gather_rows(kv, ksets[0]),
         ref.gather_rows_ref(kv, ksets[0]))
    pick, pick_c = cycler(ksets), cycler([x.long() for x in ksets])
    k_ms = device_ms(torch, lambda: ops.gather_rows(kv, pick()))
    p_ms = device_ms(torch, lambda: ref.gather_rows_ref(kv, pick()))
    l_ms = device_ms(torch, lambda: kv.index_select(0, pick_c()))
    rb = kv.shape[1] * kv.element_size()
    nb = bytes_of(kv, ksets[0])
    shapes["kv_page_rows_16k"] = dict(rows=R, row_bytes=rb, ms=k_ms,
                                      plain_ms=p_ms, library_ms=l_ms,
                                      bound_ms=nb / rate * 1e3,
                                      max_abs_err=0.0)
    log(f"[rowcopy] gather_rows at the KV page-in (R={R} rows of {rb} B, "
        f"plan {plan_of(kv, ksets[0])}): equal to plain; {k_ms * 1e3:.2f} us "
        f"(plain {p_ms * 1e3:.2f} us, library index_select "
        f"{l_ms * 1e3:.2f} us, bound {nb / rate * 1e6:.3f} us by bytes) "
        f"[{card}]")
    del kv

    # gather_rows_into at the object-ingress shape: slab rows into the
    # frame pool's rows, masked moves (zeros) onto the trash frame's row
    P, D = state.slab.shape[1], state.slab.shape[2]
    slab_rows = state.slab.view(-1, D)
    frame_rows = state.frames.view(-1, D)
    trash = frame_rows.shape[0] - P
    sets = []
    for _ in range(8):
        src = idx_for(BATCH, slab_rows.shape[0] - P, 0.3)
        dst = torch.randperm(trash, generator=g, device=dev)[:BATCH].to(
            torch.int32)
        sets.append((torch.where(src >= 0, dst, trash).to(torch.int32), src))
    a, b = frame_rows.clone(), frame_rows.clone()
    d0, i0 = sets[0]
    ops.gather_rows_into(a, d0, slab_rows, i0)
    ref.gather_rows_into_ref(b, d0, slab_rows, i0)
    same("gather_rows_into, object ingress (frames, trash row included)", a,
         b)
    check(int((i0 < 0).sum()) > 1, "[rowcopy] no shared trash row")
    pick = cycler(sets)

    def two_step():
        d, i = pick()
        a.index_put_((d.long(),), slab_rows.index_select(
            0, i.clamp_min(0).long()))
    k_ms = device_ms(torch, lambda: ops.gather_rows_into(
        a, *dst_pool_idx(pick(), slab_rows)))
    p_ms = device_ms(torch, lambda: ref.gather_rows_into_ref(
        a, *dst_pool_idx(pick(), slab_rows)))
    l_ms = device_ms(torch, two_step)
    rb = D * slab_rows.element_size()
    nb = sum(bytes_of(slab_rows, i) + 4 * BATCH for _, i in sets) / len(sets)
    shapes["into_ingress"] = dict(rows=BATCH, row_bytes=rb, ms=k_ms,
                                  plain_ms=p_ms, two_step_ms=l_ms,
                                  bound_ms=nb / rate * 1e3, max_abs_err=0.0)
    log(f"[rowcopy] gather_rows_into at object ingress (R={BATCH} rows of "
        f"{rb} B into the frame pool, ~30% masked onto the trash row): equal "
        f"to plain, trash row included; {k_ms * 1e3:.2f} us (plain "
        f"{p_ms * 1e3:.2f} us, index_select + index_put_ {l_ms * 1e3:.2f} "
        f"us, bound {nb / rate * 1e6:.3f} us by bytes) [{card}]")
    del a, b
    torch.cuda.synchronize()
    return shapes


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


def profiled(torch, fn, reps):
    """``reps`` calls of ``fn`` under torch.profiler: (wall s, device busy
    s, device operations, each per call; rows of (device us, count, name)
    over the run)."""
    from torch.profiler import ProfilerActivity, profile
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
        # the program's spans (``engine.*``, as around a graph's replay)
        # show on the device too, as the time of the kernels inside them
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.key.startswith("engine."):
            rows.append((getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)),
                         e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    ops = sum(r[1] for r in rows)
    return wall / reps, busy / reps, ops / reps, rows


def profile_ticks(torch, eng, ids_all, first: int, n: int, card: str,
                  tag: str, top: int = 12) -> float:
    """Where the serving time goes: ``n`` sync ticks under torch.profiler
    (device time by kernel, device operations, the device's busy share of
    the wall time).  Returns the device operations per tick."""
    ticks = iter(range(first, first + n))

    def tick():
        eng.submit(ids_all[next(ticks)])
        eng.drain()
    wall, busy, ops, rows = profiled(torch, tick, n)
    log(f"[{tag}] profile of {n} sync ticks: wall {wall * 1e3:.2f} ms/tick, "
        f"device busy {busy * 1e3:.3f} ms/tick ({100 * busy / wall:.1f}% of "
        f"wall), {ops:.0f} device ops/tick [{card}]")
    for dev, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[{tag}]   {dev / 1e3 / n:8.3f} ms/tick {count / n:7.1f} "
            f"per tick  {key[:90]}")
    return ops


def phase_profile(torch, plane, eng, card: str):
    """One foreground evacuation and one epoch under torch.profiler."""
    for name, fn in (("evacuate (16 victims)",
                      lambda: plane.evacuate(eng.pcfg, eng.state)),
                     ("advance_epoch",
                      lambda: plane.advance_epoch(eng.pcfg, eng.state))):
        wall, busy, ops, _ = profiled(torch, fn, 1)
        log(f"[profile] {name}: wall {wall * 1e3:.2f} ms, device busy "
            f"{busy * 1e3:.3f} ms, {ops:.0f} device ops [{card}]")


# --------------------------------------------------------------------------
# the baseline planes and the robust engine at the store's full size
# --------------------------------------------------------------------------

class counted_reads:
    """set_sync_debug_mode("error") around a block, except inside the
    object plane's reclaim reads (``ObjectReclaim._read``, which count
    themselves): any other host read in the block fails the run."""

    def __init__(self, torch, baselines):
        self.torch, self.cls = torch, baselines.ObjectReclaim
        self.orig = self.cls._read

    def __enter__(self):
        torch, orig = self.torch, self.orig

        def read(rec, cfg, s):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return orig(rec, cfg, s)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        self.cls._read = read
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self.cls._read = self.orig
        return False


def check_replayed(torch, m, ops, eng, plain_s, ids_all, served, launches,
                   tag: str):
    """Hold a replaying engine's rows, final state and kernel launch counts
    (``launches``, over the ticks of ``served``), bit for bit and launch
    for launch, against the plain plane calls (the evacuation rounds and
    epochs on the same ticks) on ``plain_s``, a clone of its state taken
    before its first tick."""
    cfg, pcfg = eng.cfg, eng.pcfg
    check(eng.replay_counts["failed"] == 0
          and eng.replay_counts["replays"] > 0,
          f"{tag}: the engine did not replay: {eng.replay_counts}")
    mism = torch.zeros((), dtype=torch.int64, device=ids_all.device)
    before = ops.launch_counts()
    for t, rows in enumerate(served, start=1):
        ids = ids_all[t - 1]
        if cfg.plane == "paging":
            _, want = m.batch.paging_access(pcfg, plain_s, ids)
        else:
            _, want = m.plane.access(pcfg, plain_s, ids)
            if t % cfg.evac_every == 0:
                m.plane.evacuate(pcfg, plain_s)
            if cfg.epoch_every and t % cfg.epoch_every == 0:
                m.plane.advance_epoch(pcfg, plain_s)
        mism += (rows != want).any(dim=1).sum()
    plain = {k: n - before[k] for k, n in ops.launch_counts().items()}
    check(int(mism) == 0, f"{tag}: {int(mism)} replayed rows differ from "
                          f"the plain plane calls")
    check(_states_equal(torch, m.convert, eng.state, plain_s),
          f"{tag}: the replaying engine's state differs from the plain "
          f"plane calls'")
    check(launches == plain,
          f"{tag}: the replaying engine counts kernel launches {launches}, "
          f"the plain plane calls {plain}")
    log(f"[{tag}] the engine's graph replays == the plain plane calls on a "
        f"clone, {len(served)} ticks, rows and state bit for bit, kernel "
        f"launches equal (gather_rows "
        f"{launches['gather_rows'] / len(served):.2f} a tick) "
        f"({eng.replay_counts})")


def phase_baseline(torch, m, ops, plane: str, data_t, ids_all,
                   card: str) -> tuple[dict, float]:
    """The paging or object plane through the launcher's recipe and the
    pipelined engine: SERVE_TICKS ticks of mcd_cl under
    set_sync_debug_mode("error") (the object plane's reclaim reads alone
    excepted, and counted), every served row checked on the card, then 16
    profiled ticks.  Returns (launch counts of the run, device ops/tick)."""
    dev = torch.device("cuda")
    pcfg = m.serve.kv_plane_config(OBJECTS, 0.25)
    t0 = time.time()
    eng = m.engine.Engine(m.engine.EngineConfig(
        plane=plane, batch=BATCH, dispatch="pipelined"), pcfg, data_t,
        device=dev)
    torch.cuda.synchronize()
    log(f"[{plane}] plane: {OBJECTS} objects, slab "
        f"{tuple(eng.state.slab.shape)}, frames "
        f"{tuple(eng.state.frames.shape)}, set up in {time.time() - t0:.1f}s")
    rec = eng.reclaim
    reads0, rounds0 = (rec.reads, rec.rounds) if rec else (0, 0)
    mism = torch.zeros((), dtype=torch.int64, device=dev)
    plain_s = eng.state.clone() if plane == "paging" else None
    served = []
    eng.latency = m.engine.LatencyTracker()
    tick_ms = []
    ops.reset_launch_counts()
    with counted_reads(torch, m.baselines):
        t0 = time.time()
        for t in range(SERVE_TICKS):
            ts = time.time()
            rows = eng.submit(ids_all[t])
            mism += (rows != data_t[ids_all[t]]).any(dim=1).sum()
            if plain_s is not None:
                served.append(rows)
            tick_ms.append((time.time() - ts) * 1e3)
        eng.drain()
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = ops.launch_counts()
    n_mism = int(mism)
    stats = {k: int(v) for k, v in eng.state.stats._asdict().items()}
    lat = eng.latency.summary()
    log(f"[{plane}] {SERVE_TICKS} ticks x {BATCH} requests (mcd_cl) in "
        f"{wall:.3f}s: {SERVE_TICKS * BATCH / wall:.0f} requests/s, batch "
        f"latency p50 {lat['p50_us']:.0f} us p99 {lat['p99_us']:.0f} us, "
        f"host submit p50 {statistics.median(tick_ms):.2f} ms [{card}]")
    log(f"[{plane}] stats {stats}")
    log(f"[{plane}] kernel launches {launches} "
        f"({ {k: v / SERVE_TICKS for k, v in launches.items()} } per tick; "
        f"a graph replay counts the launches its captured call counted: "
        f"{eng.replay_counts})")
    check(n_mism == 0, f"{plane}: {n_mism} served rows differ from the data")
    if plane == "paging":
        check(stats["page_ins"] > 0 and stats["obj_ins"] == 0,
              "paging: no page-in, or an object fetch")
        check_replayed(torch, m, ops, eng, plain_s, ids_all, served,
                       launches, plane)
    else:
        check(stats["obj_ins"] > 0 and stats["page_ins"] == 0,
              "object: no object fetch, or a page-in")
        log(f"[{plane}] reclaim host reads in the run: "
            f"{rec.reads - reads0}, reclaim rounds {rec.rounds - rounds0}")
    check(launches["gather_rows"] > 0, f"{plane}: gather_rows never launched")
    log(f"[{plane}] 0 of {SERVE_TICKS * BATCH} served rows differ from the "
        f"data; no host sync under set_sync_debug_mode('error')")
    n_ops = profile_ticks(torch, eng, ids_all, SERVE_TICKS, 16, card, plane,
                          top=8)
    del eng
    torch.cuda.empty_cache()
    return launches, n_ops


def phase_reclaim(torch, m, ops, card: str) -> dict:
    """The object plane's reclaim on the card: the launcher's recipe at
    RECLAIM_OBJECTS objects (the same 128 B rows and 25% local), mcd_cl at
    batch 1024 until at least RECLAIM_MIN objects were evicted, once with
    the full LRU scan and once with a window of RECLAIM_BUDGET.  Each tick
    that can run short of frames starts from a clone; from the first tick
    that evicts, the clone runs the reference executor beside the batch
    executor: every row and every field bit for bit, every tick.  Returns
    the launch counts."""
    dev = torch.device("cuda")
    N = RECLAIM_OBJECTS
    data_t = torch.from_numpy(m.serve.kv_data(N, SEED)).to(dev)
    wl = list(m.kvworkload.zipf_churn(N, BATCH, RECLAIM_MAX_TICKS, seed=SEED))
    max_alloc = BATCH // 8 + 1           # fresh log pages a batch can take
    launches = None
    for budget in (0, RECLAIM_BUDGET):
        pcfg = m.serve.kv_plane_config(N, 0.25, lru_scan_budget=budget)
        sb = m.state.create(pcfg, data_t, device=dev)
        rb, sr, rr = m.baselines.ObjectReclaim(), None, None
        mism = torch.zeros((), dtype=torch.int64, device=dev)
        ops.reset_launch_counts()
        t0 = time.time()
        for t, ids in enumerate(wl):
            ids_t = torch.from_numpy(ids).to(dev)
            if sr is None:
                # this tick can reclaim only if its fresh pages can leave
                # fewer than 2 frames free
                free = int((sb.vpage_of[:pcfg.num_frames] < 0).sum())
                prev = sb.clone() if free - max_alloc < 2 else None
                outs0 = int(sb.stats.obj_outs)
            _, rows = m.baselines.object_access(pcfg, sb, ids_t, reclaim=rb)
            mism += (rows != data_t[ids_t]).any(dim=1).sum()
            if sr is None:
                if prev is None or int(sb.stats.obj_outs) == outs0:
                    continue
                sr, rr, t_clone = prev, m.baselines.ObjectReclaim(), t
            _, rrows = m.baselines.object_access(pcfg, sr, ids_t,
                                                 mode="reference", reclaim=rr)
            check(torch.equal(rows, rrows),
                  f"reclaim (budget {budget}): reference rows differ at "
                  f"tick {t}")
            check(_states_equal(torch, m.convert, sb, sr),
                  f"reclaim (budget {budget}): batch and reference states "
                  f"differ at tick {t}")
            if int(sb.stats.obj_outs) >= RECLAIM_MIN:
                break
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = ops.launch_counts()
        st = {k: int(v) for k, v in sb.stats._asdict().items()}
        check(int(mism) == 0, f"reclaim (budget {budget}): {int(mism)} "
                              f"served rows differ from the data")
        check(st["obj_outs"] >= RECLAIM_MIN,
              f"reclaim (budget {budget}): {st['obj_outs']} evictions in "
              f"{len(wl)} ticks")
        check(all(m.plane.check_invariants(pcfg, sb).values()),
              f"reclaim (budget {budget}): invariants")
        # the same ticks through the plain versions on the host's CPU: the
        # card's state must be the CPU's, bit for bit
        t1 = time.time()
        sc = m.state.create(pcfg, data_t.cpu(), device="cpu")
        rc = m.baselines.ObjectReclaim()
        for ids in wl[:t + 1]:
            m.baselines.object_access(pcfg, sc, torch.from_numpy(ids),
                                      reclaim=rc)
        check(_states_equal(torch, m.convert, sb, sc),
              f"reclaim (budget {budget}): the card's state differs from "
              f"the CPU's after {t + 1} ticks")
        cpu_s = time.time() - t1
        check(launches["gather_rows"] > 0, "reclaim: gather_rows never "
                                           "launched")
        per_round = rb.seconds / max(rb.rounds, 1)
        log(f"[reclaim] lru_scan_budget={budget}: {t + 1} ticks of mcd_cl "
            f"at {N} objects ({pcfg.num_frames} frames) in {wall:.2f}s; "
            f"{st['obj_outs']} objects evicted in {rb.rounds} rounds of "
            f"{pcfg.object_evict_batch}, {rb.reads} host reads; "
            f"{per_round * 1e3:.3f} ms per reclaim round (host clock, reads "
            f"included), lru_scans {st['lru_scans']} [{card}]")
        log(f"[reclaim] lru_scan_budget={budget}: batch == reference "
            f"executor, rows and every field, over ticks {t_clone}-{t} on a "
            f"clone; every served row equal to the data; the final state "
            f"equal to a CPU run of the same {t + 1} ticks ({cpu_s:.1f}s)")
        del sb, sr, prev, sc
    torch.cuda.empty_cache()
    return launches


def phase_robust(torch, m, ops, data_t, card: str) -> dict:
    """The robust hybrid engine at full size, as [serve] runs it
    (evacuation, epoch_every=16), dispatch="sync", through fig_faults'
    scenarios (benchmarks/fig_faults.py): ROBUST_TICKS ticks of mcd_cl
    offering 7/8 of BATCH new requests (the tail slots carry retries),
    faults over the middle third.  A fault-free run, a 20% transient
    failure window with max_retries=4 (run twice: the counters must
    replay), and a total outage with max_retries=1 and the breaker armed.
    Every served slot's row (retries too) is checked on the card, every
    unserved one is zero, and every offered request leaves exactly once.
    Returns the launch counts of the 20% run."""
    import numpy as np
    dev = torch.device("cuda")
    F = m.faults
    pcfg = m.serve.kv_plane_config(OBJECTS, 0.25, evac_garbage_threshold=-1.0)
    steps, req = ROBUST_TICKS, BATCH - BATCH // 8   # fig_faults: 56 of 64
    b1, b2 = steps // 3, 2 * steps // 3
    window = (b1 + 2, b2 + 2)        # engine tick i plans at device tick i+1
    wl = list(m.kvworkload.zipf_churn(OBJECTS, req, steps, seed=3))
    offered = steps * req

    def drive(name, sched, **kw):
        eng = m.engine.Engine(m.engine.EngineConfig(
            plane="hybrid", batch=BATCH, dispatch="sync", evac_every=64,
            epoch_every=16, faults=sched, watchdog_s=300.0, **kw),
            pcfg, data_t, device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        retire = eng._retire_one

        def checked_retire():
            # the batch about to retire: its served slots hold the true
            # rows, its unserved slots zero rows
            e = eng._inflight[0]
            retire()
            sv = e.served.numpy() & (e.ids >= 0)
            ok = torch.from_numpy(np.nonzero(sv)[0]).to(dev)
            no = torch.from_numpy(np.nonzero(~sv)[0]).to(dev)
            ids = torch.from_numpy(e.ids).to(dev)
            bad.add_((e.rows[ok] != data_t[ids[ok]]).any(dim=1).sum()
                     + e.rows[no].any(dim=1).sum())
        eng._retire_one = checked_retire
        tripped = False
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        for ids in wl:
            eng.submit(ids)
            eng.drain()
            tripped |= eng.breaker_open
        eng.flush_retries()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = ops.launch_counts()
        c = dict(eng.counters)
        stats = {k: int(v) for k, v in eng.state.stats._asdict().items()}
        out = dict(counters=c, stats=stats, tripped=tripped,
                   open_at_end=eng.breaker_open, launches=launches,
                   p50=eng.latency.percentile(50),
                   p99=eng.latency.percentile(99), wall=wall)
        check(int(bad) == 0, f"robust {name}: {int(bad)} served rows wrong "
                             f"or unserved rows not zero")
        check(c["served"] + c["shed_requests"] == offered,
              f"robust {name}: served {c['served']} + shed "
              f"{c['shed_requests']} != offered {offered}")
        check(not eng._retryq, f"robust {name}: retries left queued")
        log(f"[robust] {name}: {steps} ticks in {wall:.3f}s, goodput "
            f"{c['served'] / wall:.0f} requests/s, batch latency p50 "
            f"{out['p50']:.0f} us p99 {out['p99']:.0f} us; counters {c}; "
            f"fetch_failures {stats['fetch_failures']} [{card}]")
        del eng
        torch.cuda.empty_cache()
        return out

    base = drive("fault-free", F.NULL, max_retries=4)
    p20s = F.Schedule(seed=11, fail_prob=0.2, fail_window=window)
    p20 = drive("p20_retry", p20s, max_retries=4)
    check(p20["counters"]["fetch_retries"] > 0
          and p20["stats"]["fetch_failures"] > 0,
          "robust p20_retry: no fetch failed or none was retried")
    replay = drive("p20_retry replay", p20s, max_retries=4)
    check(replay["counters"] == p20["counters"]
          and replay["stats"] == p20["stats"],
          "robust p20_retry: a same-seed replay gave other counters")
    outage = drive("outage_breaker", F.Schedule(seed=11,
                                                outages=(window + (-1,),)),
                   max_retries=1, breaker_threshold=0.5,
                   breaker_probe_every=4)
    oc = outage["counters"]
    check(outage["tripped"] and oc["breaker_trips"] >= 1,
          "robust outage_breaker: the breaker never opened")
    check(not outage["open_at_end"], "robust outage_breaker: the breaker "
                                     "did not close after the outage")
    check(oc["degraded_ticks"] > 0, "robust outage_breaker: no degraded tick")
    for k in ("gather_rows", "compact_pages", "cat_decay"):
        check(p20["launches"][k] > 0 and outage["launches"][k] > 0,
              f"robust: kernel {k} was never launched")
    log(f"[robust] p99 with faults {p20['p99']:.0f} us (p20_retry), "
        f"{outage['p99']:.0f} us (outage_breaker), fault-free "
        f"{base['p99']:.0f} us; same-seed replay: identical counters; "
        f"kernel launches (p20_retry) {p20['launches']} [{card}]")
    return p20["launches"]


# --------------------------------------------------------------------------
# the sharded far tier (core.shardplane) at the store's full size
# --------------------------------------------------------------------------

class Tally:
    """The kernel launches of the calls made through it, and of no other:
    ``tally(fn, *args)`` calls ``fn`` and adds the change in the counts."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = dict.fromkeys(ops.launch_counts(), 0)

    def __call__(self, fn, *args, **kw):
        n0 = self.ops.launch_counts()
        out = fn(*args, **kw)
        for k, v in self.ops.launch_counts().items():
            self.counts[k] += v - n0[k]
        return out


def shard_engine(m, plane: str, data_t, **kw):
    """The launcher's plane over SHARDS shards through the pipelined
    engine (the loop oracle on one card), as [serve] runs it."""
    pcfg = m.serve.kv_plane_config(OBJECTS, 0.25, evac_garbage_threshold=-1.0)
    kw = dict(dict(dispatch="pipelined", evac_every=64, epoch_every=16),
              **kw)
    return m.engine.Engine(m.engine.EngineConfig(
        plane=plane, batch=BATCH, shards=SHARDS, **kw), pcfg, data_t,
        device=data_t.device)


def serve_checked(torch, eng, data_t, ids_all, ticks: range):
    """``eng.submit`` over ``ticks`` with every served row checked on the
    card; returns (rows that differ, wall s, host submit ms per tick)."""
    mism = torch.zeros((), dtype=torch.int64, device=data_t.device)
    tick_ms = []
    torch.cuda.synchronize()
    t0 = time.time()
    for t in ticks:
        ts = time.time()
        rows = eng.submit(ids_all[t])
        mism += (rows != data_t[ids_all[t]]).any(dim=1).sum()
        tick_ms.append((time.time() - ts) * 1e3)
    eng.drain()
    torch.cuda.synchronize()
    return int(mism), time.time() - t0, tick_ms


def phase_shard(torch, m, ops, data_t, ids_all, card: str):
    """The sharded hybrid store on one card: SHARD_TICKS ticks of mcd_cl
    through the pipelined engine, every row checked; every shard's
    invariants; the serial schedule == the overlap schedule on clones; a
    spilling budget; the paging and object planes sharded; the reference
    executor == the batched one at 512 objects; no host sync; a 16-tick
    profile.  Returns (launch counts of the serve run, device ops/tick,
    requests/s)."""
    sp = m.shardplane
    t0 = time.time()
    eng = shard_engine(m, "hybrid", data_t)
    scfg, R = eng.scfg, BATCH // SHARDS
    torch.cuda.synchronize()
    s0 = eng.state[0]
    log(f"[shard] plane: {OBJECTS} objects over {SHARDS} shards "
        f"({scfg.shard.num_objs} objects, slab {tuple(s0.slab.shape)}, "
        f"frames {tuple(s0.frames.shape)} a shard), {R} requests a shard, "
        f"{scfg.rounds} round ({scfg.exchange} exchange), set up in "
        f"{time.time() - t0:.1f}s")
    ops.reset_launch_counts()
    eng.latency = m.engine.LatencyTracker()
    n_mism, wall, tick_ms = serve_checked(torch, eng, data_t, ids_all,
                                          range(SHARD_TICKS))
    launches = ops.launch_counts()
    stats = {k: int(v) for k, v in sp.stats_total(eng.state)._asdict().items()}
    lat = eng.latency.summary()
    rps = SHARD_TICKS * BATCH / wall
    log(f"[shard] {SHARD_TICKS} ticks x {BATCH} requests (mcd_cl) in "
        f"{wall:.3f}s: {rps:.0f} requests/s, batch latency p50 "
        f"{lat['p50_us']:.0f} us p99 {lat['p99_us']:.0f} us, host submit "
        f"p50 {statistics.median(tick_ms):.2f} ms [{card}]")
    log(f"[shard] stats (summed over shards) {stats}")
    log(f"[shard] kernel launches {launches} "
        f"({ {k: v / SHARD_TICKS for k, v in launches.items()} } per tick)")
    check(n_mism == 0, f"shard: {n_mism} served rows differ from the data")
    for k in ("page_ins", "obj_ins", "evac_pages", "epochs"):
        check(stats[k] > 0, f"shard: {k} is 0")
    for k in ("gather_rows", "compact_pages", "cat_decay"):
        check(launches[k] > 0, f"shard: kernel {k} was never launched")
    thr = [float(s.car_thr) for s in eng.state]
    check(thr == [thr[0]] * SHARDS, f"shard: thresholds apart {thr}")
    inv = sp.check_invariants(scfg, eng.state)
    check(all(inv.values()), f"shard: invariants {inv}")
    log(f"[shard] 0 of {SHARD_TICKS * BATCH} served rows differ from the "
        f"data; every shard's invariants hold; thresholds in lockstep "
        f"({thr[0]:.4f})")

    # the serial schedule on clones: the same rows and state
    serial = dataclasses.replace(scfg, exchange="serial")
    so = [s.clone() for s in eng.state]
    ss = [s.clone() for s in eng.state]
    same = True
    for t in range(SERVE_TICKS, SERVE_TICKS + SHARD_SERIAL_TICKS):
        ids = ids_all[t].reshape(SHARDS, R)
        _, ro = sp.access(scfg, so, ids)
        _, rs = sp.access(serial, ss, ids)
        same &= torch.equal(ro, rs) and torch.equal(
            ro.reshape(BATCH, -1), data_t[ids_all[t]])
        if t % 16 == 0:
            for st_ in (so, ss):
                sp.advance_epoch(scfg, sp.evacuate(scfg, st_))
    check(same, "shard: the serial schedule's rows differ")
    check(all(_states_equal(torch, m.convert, a, b) for a, b in zip(so, ss)),
          "shard: the serial schedule's state differs")
    del so, ss
    log(f"[shard] serial == overlap schedule over {SHARD_SERIAL_TICKS} "
        f"ticks on clones: rows and every field of every shard")

    n_ops = profile_ticks(torch, eng, ids_all, SERVE_TICKS, 16, card, "shard")

    # the plane's path makes no host sync
    s = eng.state
    mism = torch.zeros((), dtype=torch.int64, device=data_t.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(SERVE_TICKS, SERVE_TICKS + NOSYNC_TICKS):
            _, rows = sp.access(scfg, s, ids_all[t].reshape(SHARDS, R))
            mism += (rows.reshape(BATCH, -1) != data_t[ids_all[t]]).any(
                dim=1).sum()
            if t % 16 == 0:
                sp.evacuate(scfg, s)
            if t % 8 == 0:
                sp.advance_epoch(scfg, s)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(int(mism) == 0, "shard: rows differ under sync-debug mode")
    log(f"[shard] {NOSYNC_TICKS} ticks of shardplane access/evacuate/"
        f"advance_epoch under set_sync_debug_mode('error'): no host sync, "
        f"rows correct")
    del eng, s
    torch.cuda.empty_cache()

    # a spilling budget, then the paging and object planes sharded.  The
    # spilling run takes uniform traffic: mcd_cl's zipf repeats its hot
    # keys, so a source sends an owner at most ~45 distinct ids of its
    # 256 and a budget of 64 never spills on it
    uni = torch.from_numpy(m.np.stack(list(m.kvworkload.uniform(
        OBJECTS, BATCH, SHARD_SPILL_TICKS, seed=SEED)))).to(data_t.device)
    for plane, ticks, kw in (("hybrid", SHARD_SPILL_TICKS,
                              dict(shard_budget=SHARD_SPILL_BUDGET)),
                             ("paging", SHARD_PLANE_TICKS, {}),
                             ("object", SHARD_PLANE_TICKS, {})):
        e = shard_engine(m, plane, data_t, **kw)
        n_mism, wall, _ = serve_checked(torch, e, data_t,
                                        uni if kw else ids_all, range(ticks))
        st = {k: int(v) for k, v in sp.stats_total(e.state)._asdict().items()}
        tag = (f"{plane}, uniform traffic, budget {kw['shard_budget']} "
               f"({e.scfg.rounds} rounds)" if kw else plane)
        check(n_mism == 0, f"shard {tag}: {n_mism} served rows differ")
        check(all(sp.check_invariants(e.scfg, e.state).values()),
              f"shard {tag}: invariants")
        if kw:
            check(st["ingress_spills"] > 0, "shard: the budget never spilled")
        check(st["page_ins"] + st["obj_ins"] > 0, f"shard {tag}: no ingress")
        log(f"[shard] {tag}: {ticks} ticks in {wall:.3f}s "
            f"({ticks * BATCH / wall:.0f} requests/s), every row right; "
            f"ingress_spills {st['ingress_spills']} page_ins "
            f"{st['page_ins']} obj_ins {st['obj_ins']} [{card}]")
        del e
        torch.cuda.empty_cache()

    shard_small(torch, m, data_t.device)
    return launches, n_ops, rps


def shard_small(torch, m, dev) -> None:
    """At 512 objects over SHARDS shards (4 frames a shard, the fewest a
    plane may have), 24 ticks of each plane: the reference executor on the
    card == the batched one on the card == the batched one on the CPU,
    rows and every field.  The CPU applies duplicate scatter writes in
    order, as JAX does; the card holds to it only where the plane orders
    them itself (``plane.last_writes`` in the evacuation).  There the
    reference plane itself serves some rows of other objects (ROADMAP
    Queue 3), so rows against the data are counted and reported, not
    required."""
    sp = m.shardplane
    objects, batch = 512, 32
    pcfg = m.serve.kv_plane_config(objects, 0.25)
    small = torch.from_numpy(m.serve.kv_data(objects, SEED))
    off = {}
    for plane in ("hybrid", "paging", "object"):
        cfg = sp.make_config(pcfg, SHARDS, batch // SHARDS, plane=plane)
        runs = {("batch", "cuda"): sp.create(cfg, small.to(dev), device=dev),
                ("reference", "cuda"): sp.create(cfg, small.to(dev),
                                                 device=dev),
                ("batch", "cpu"): sp.create(cfg, small, device="cpu")}
        off[plane] = 0
        for t, ids in enumerate(m.kvworkload.zipf_churn(objects, batch, 24,
                                                        seed=SEED)):
            ids = torch.from_numpy(ids).reshape(SHARDS, -1)
            rows = {}
            for (mode, d), x in runs.items():
                _, rows[mode, d] = sp.access(cfg, x, ids.to(x[0].device),
                                             mode=mode)
                if plane == "hybrid" and t % 6 == 5:
                    sp.advance_epoch(cfg, sp.evacuate(
                        cfg, x, garbage_threshold=-1.0, max_pages=4))
            rb = rows["batch", "cuda"]
            check(torch.equal(rb, rows["reference", "cuda"]),
                  f"shard oracle ({plane}): rows differ at tick {t}")
            check(torch.equal(rb.cpu(), rows["batch", "cpu"]),
                  f"shard oracle ({plane}): the card's rows differ from the "
                  f"CPU's at tick {t}")
            off[plane] += int((rb.cpu() != small[ids]).any(dim=-1).sum())
        sb = runs["batch", "cuda"]
        for key in (("reference", "cuda"), ("batch", "cpu")):
            check(all(_states_equal(torch, m.convert, a, b)
                      for a, b in zip(sb, runs[key])),
                  f"shard oracle ({plane}): the card's batched state differs "
                  f"from the {key[0]} executor's on the {key[1]}")
    log(f"[shard] at {objects} objects over {SHARDS} shards "
        f"({cfg.shard.num_frames} frames a shard): batch == reference "
        f"executor on the card == batch on the CPU, rows and every field, "
        f"24 ticks of each plane; rows other than the data (the "
        f"reference's four-frame fault, ROADMAP Queue 3): {off}")


def phase_shard_robust(torch, m, ops, data_t, card: str) -> dict:
    """The sharded hybrid engine at full size, dispatch="sync", with the
    per-shard breaker (threshold 0.5, probes every 4 ticks, one retry) and
    an outage of shard SHARD_OUTAGE over the middle third of
    SHARD_ROBUST_TICKS ticks of mcd_cl (7/8 of the batch new requests),
    beside a fault-free twin.  Only that shard's breaker trips, and it
    closes; the healthy shards' rows (and states) are the twin's, bit for
    bit; every served slot's row is right and every offered request is
    served or shed exactly once.  Returns the faulty engine's launch
    counts (the twin's are not counted)."""
    import numpy as np
    F = m.faults
    steps, req = SHARD_ROBUST_TICKS, BATCH - BATCH // 8
    window = (steps // 3 + 2, 2 * steps // 3 + 2)
    wl = list(m.kvworkload.zipf_churn(OBJECTS, req, steps, seed=3))
    kw = dict(dispatch="sync", epoch_every=0, max_retries=1,
              breaker_threshold=0.5, breaker_probe_every=4,
              watchdog_s=300.0)
    ef = shard_engine(m, "hybrid", data_t, faults=F.Schedule(
        seed=11, outages=(window + (SHARD_OUTAGE,),)), **kw)
    e0 = shard_engine(m, "hybrid", data_t, faults=F.NULL, **kw)
    dev = data_t.device
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    retire = ef._retire_one

    def checked_retire():
        e = ef._inflight[0]
        retire()
        sv = e.served.numpy() & (e.ids >= 0)
        ok = torch.from_numpy(np.nonzero(sv)[0]).to(dev)
        no = torch.from_numpy(np.nonzero(~sv)[0]).to(dev)
        ids = torch.from_numpy(e.ids).to(dev)
        bad.add_((e.rows[ok] != data_t[ids[ok]]).any(dim=1).sum()
                 + e.rows[no].any(dim=1).sum())
    ef._retire_one = checked_retire
    O_s = ef.scfg.shard.num_objs
    diff = torch.zeros((), dtype=torch.int64, device=dev)
    open_seen = np.zeros((SHARDS,), bool)
    ops.reset_launch_counts()
    tally = Tally(ops)                  # the faulty engine's launches only
    torch.cuda.synchronize()
    t0 = time.time()
    for ids in wl:
        rf = tally(ef.serve_batch, ids)
        r0 = e0.serve_batch(ids)
        healthy = torch.from_numpy(ids // O_s != SHARD_OUTAGE).to(dev)
        diff += (rf[healthy] != r0[healthy]).any(dim=1).sum()
        open_seen |= ef.breaker_open_shards
    torch.cuda.synchronize()
    wall = time.time() - t0
    healthy_states = all(_states_equal(torch, m.convert, ef.state[k],
                                       e0.state[k])
                         for k in range(SHARDS) if k != SHARD_OUTAGE)
    tally(ef.flush_retries)
    e0.flush_retries()
    launches = tally.counts
    rep, rep0 = ef.run([]), e0.run([])
    c, offered = rep["counters"], steps * req
    log(f"[shardrobust] {steps} ticks x {req} new requests, shard "
        f"{SHARD_OUTAGE} out over ticks {window[0]}-{window[1] - 1}, both "
        f"engines in {wall:.3f}s; counters {c}; fetch_failures per shard "
        f"{rep['fetch_failures_per_shard']}; served per shard "
        f"{rep['served_per_shard']} (fault-free {rep0['served_per_shard']}); "
        f"breakers ever open {open_seen.tolist()} [{card}]")
    check(int(bad) == 0, f"shardrobust: {int(bad)} served rows wrong or "
                         f"unserved rows not zero")
    check(int(diff) == 0, f"shardrobust: {int(diff)} healthy-shard rows "
                          f"differ from the fault-free run")
    check(healthy_states, "shardrobust: a healthy shard's state differs "
                          "from the fault-free run")
    check(open_seen[SHARD_OUTAGE] and open_seen.sum() == 1,
          f"shardrobust: breakers opened {open_seen.tolist()}")
    check(not ef.breaker_open, "shardrobust: the breaker did not close")
    check(c["degraded_ticks"] > 0 and c["breaker_trips"] >= 1,
          "shardrobust: no trip or no degraded tick")
    for r in (rep, rep0):
        cc = r["counters"]
        check(cc["served"] + cc["shed_requests"] == offered,
              f"shardrobust: served {cc['served']} + shed "
              f"{cc['shed_requests']} != offered {offered}")
    failed = rep["fetch_failures_per_shard"]
    check(failed[SHARD_OUTAGE] > 0 and sum(failed) == failed[SHARD_OUTAGE],
          f"shardrobust: failures per shard {failed}")
    for k in ("gather_rows", "compact_pages"):
        check(launches[k] > 0, f"shardrobust: kernel {k} never launched")
    log(f"[shardrobust] only shard {SHARD_OUTAGE}'s breaker tripped and it "
        f"closed again; the healthy shards' rows and states equal the "
        f"fault-free run's; every offered request served or shed once")
    del ef, e0
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_checks(torch, m, rank: int, world: int, init: str, data_t,
                ids_all) -> dict:
    """One rank of the far group (NCCL, one card a rank): the full-size
    store over ``world`` shards through jitted_access/update/advance_epoch/
    evacuate with the group against the loop oracle (and, at one shard,
    the plain plane), then jitted_sharded_decode with the group against
    the loop decode on llama3-8b long_500k shards.  Returns the kernel
    launch counts of the calls through the group (the loop oracle's, the
    plain plane's and the loop decode's are not counted)."""
    sp, mesh, kv = m.shardplane, m.mesh, m.kvplane
    dev = mesh.init_far(rank, world, init)
    try:
        g = mesh.make_far_group(world)
        S, R = world, BATCH // world
        pcfg = m.serve.kv_plane_config(OBJECTS, 0.25,
                                       evac_garbage_threshold=-1.0)
        scfg = sp.make_config(pcfg, S, R)
        data_t, ids_all = data_t.to(dev), ids_all.to(dev)
        so = sp.create(scfg, data_t, device=dev)
        sm = mesh.put_far(sp.create(scfg, data_t, device=dev), g)
        plain = m.state.create(pcfg, data_t, device=dev) if S == 1 else None
        fns = [(sp.jitted_access(scfg, group=x), sp.jitted_update(
            scfg, group=x), sp.jitted_advance_epoch(scfg, x),
            sp.jitted_evacuate(scfg, group=x)) for x in (None, g)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 7)
        ops = m.ops
        ops.reset_launch_counts()
        tally = Tally(ops)              # the group's calls only
        same = True
        for t in range(MESH_TICKS):
            ids = ids_all[t].reshape(S, R)
            so, ro = fns[0][0](so, ids)
            sm, rm = tally(fns[1][0], sm, ids)
            same &= torch.equal(rm, ro[rank])
            if t == 0:
                same &= torch.equal(ro.reshape(BATCH, -1), data_t[ids_all[t]])
            if plain is not None:
                _, rp = m.plane.access(pcfg, plain, ids_all[t])
                same &= torch.equal(rp, ro[0])
            if t % 2:
                rows = torch.rand((S, R, 32), generator=gen, device=dev)
                fns[0][1](so, ids, rows)
                tally(fns[1][1], sm, ids, rows)
                if plain is not None:
                    m.plane.update(pcfg, plain, ids_all[t], rows[0])
            if t % 8 == 7:
                fns[0][3](fns[0][2](so))
                tally(fns[1][3], tally(fns[1][2], sm))
                if plain is not None:
                    m.plane.evacuate(pcfg, m.plane.advance_epoch(pcfg, plain))
        check(bool(same), f"shardmesh rank {rank}: rows differ")
        check(_states_equal(torch, m.convert, sm[rank], so[rank]),
              f"shardmesh rank {rank}: the group's shard differs from the "
              f"loop oracle's")
        if plain is not None:
            check(_states_equal(torch, m.convert, plain, so[0]),
                  "shardmesh: one shard differs from the plain plane")
        check(all(sp.check_invariants(scfg, sm).values()),
              f"shardmesh rank {rank}: invariants")
        tot = sp.stats_total(sm, g)
        log(f"[shardmesh] rank {rank}/{world}: {MESH_TICKS} ticks of access"
            f" (updates, epochs, evacuations between) through the group == "
            f"the loop oracle{' == the plain plane' if plain else ''}, rows "
            f"and every field; page_ins {int(tot.page_ins)} obj_ins "
            f"{int(tot.obj_ins)} evac_pages {int(tot.evac_pages)}")
        del so, sm, plain
        torch.cuda.empty_cache()
        # the truncated exchange (phase_probe): this rank's checksum through
        # the group == the loop oracle's, and its device time a call
        ids = ids_all[0].reshape(S, R)
        for phase in ("pack", "ingress"):
            want = sp.phase_probe(scfg, phase)(ids)
            probe = sp.phase_probe(scfg, phase, g)
            got = tally(probe, ids)
            check(got.shape == (1,) and int(got[0]) == int(want[rank]),
                  f"shardmesh rank {rank}: phase_probe({phase!r}) "
                  f"{got.tolist()} against the loop oracle's "
                  f"{want.tolist()}")
            us = device_ms(torch, lambda: probe(ids)) * 1e3
            log(f"[shardmesh] rank {rank}/{world}: phase_probe({phase!r}) "
                f"through the group == the loop oracle (checksum "
                f"{int(got[0])}), {us:.2f} us of device time a call "
                f"({scfg.rounds} round(s) of {R} ids)")
        # the KV plane's mesh decode: S long_500k shards of llama3-8b
        kg = torch.Generator(device=dev)
        kg.manual_seed(SEED + 8)
        shards = [sparse_plane(torch, kv, kg) for _ in range(S)]
        cfg, qs = shards[0][0], shards[0][2]
        ko = [x[1] for x in shards]
        km = [x[1].clone() if d == rank else None for d, x in
              enumerate(shards)]
        lengths = torch.full((1,), S * cfg.num_pages * cfg.page_tokens,
                             dtype=torch.int32, device=dev)
        dec = [kv.jitted_sharded_decode(cfg, group=x) for x in (None, g)]
        same = True
        for i in range(MESH_KV_STEPS):
            oo, ko = dec[0](ko, qs[i % len(qs)], lengths)
            om, km = tally(dec[1], km, qs[i % len(qs)], lengths)
            same &= torch.equal(oo, om)
        check(same, f"shardmesh rank {rank}: decode outputs differ")
        check(_kv_states_equal(m.convert, cfg, km[rank], ko[rank]),
              f"shardmesh rank {rank}: KV shard state differs")
        log(f"[shardmesh] rank {rank}/{world}: {MESH_KV_STEPS} "
            f"jitted_sharded_decode steps through the group (llama3-8b "
            f"long_500k, {S} shard(s) of {cfg.num_pages} pages) == the loop "
            f"decode, outputs and state")
        torch.cuda.synchronize()
        return tally.counts
    finally:
        m.dist.destroy_process_group()


def phase_shard_mesh(torch, m, data_t, ids_all, card: str) -> dict:
    """The mesh path over NCCL: in this process at one card (world size 1,
    one shard), else one process a card.  Returns rank 0's launch
    counts."""
    n = torch.cuda.device_count()
    init = f"tcp://localhost:{free_port()}"
    t0 = time.time()
    if n == 1:
        launches = mesh_checks(torch, m, 0, 1, init, data_t, ids_all)
        log(f"[shardmesh] the exchange across cards was not measured: one "
            f"card here, and NCCL takes one card a rank, so the group has "
            f"one rank and one shard ({time.time() - t0:.1f}s) [{card}]")
        return launches
    procs = [subprocess.Popen([sys.executable, __file__, "--mesh-rank",
                               str(r), str(n), init],
                              stdout=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        sys.stdout.write(out)
        check(p.returncode == 0, f"shardmesh: rank {r} exited "
                                 f"{p.returncode}")
    log(f"[shardmesh] {n} ranks, one card each ({time.time() - t0:.1f}s) "
        f"[{card}]")
    return json.loads(outs[0].strip().splitlines()[-1])


def mesh_rank_main(rank: int, world: int, init: str) -> int:
    """A spawned rank of [shardmesh]: its checks, then its launch counts as
    the last line."""
    import torch
    sys.path.insert(0, str(SRC))
    m = port_modules()
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    data_t = torch.from_numpy(m.serve.kv_data(OBJECTS, SEED)).to(dev)
    import numpy as np
    ids_all = torch.from_numpy(np.stack(list(m.kvworkload.zipf_churn(
        OBJECTS, BATCH, MESH_TICKS, seed=SEED)))).to(dev)
    launches = mesh_checks(torch, m, rank, world, init, data_t, ids_all)
    print(json.dumps(launches), flush=True)
    return 0


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


def scores_record(torch, ops, ref, q, kmax, kmin, rate, card, tag) -> dict:
    """page_scores at a plane's summaries against its plain version."""
    got = ops.page_scores(q, kmax, kmin)
    want = ref.page_scores_ref(q, kmax, kmin)
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    check(err <= tol, f"[{tag}] page_scores: max abs err {err} > {tol}")
    ms = device_ms(torch, lambda: ops.page_scores(q, kmax, kmin), n=20,
                   rounds=3)
    plain_ms = device_ms(torch, lambda: ref.page_scores_ref(q, kmax, kmin),
                         n=10, rounds=3)
    B, H, Dh = q.shape
    KVH, NP, _ = kmax.shape
    nb = 2 * KVH * NP * Dh * 4 + B * H * Dh * 2 + B * KVH * NP * 4
    bnd = bound(nb, 4 * B * H * NP * Dh, rate, PEAK_F32)
    log(f"[{tag}] page_scores {list(q.shape)} bf16 x {[KVH, NP, Dh]} f32 "
        f"(G={H // KVH}, Dh={Dh}): max abs err {err:.3g} (tolerance "
        f"{tol:.3g}); {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
        f"library none, bound {bnd[0] * 1e3:.2f} us by {bnd[1]}) [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err}


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
    r = scores_record(torch, ops, ref, qs[0], kmax, kmin, rate, card,
                      "kernel")
    out.append(kv_record("page_scores",
                         "src/repro_torch/kernels/csrc/page_scores.cu",
                         "src/repro/kernels/topk_pages.py:36", r["ms"],
                         r["plain_ms"], None, r["max_abs_err"],
                         (r["bound_ms"], r["bound_by"])))
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

    # ---- cat_update: the hybrid plane's CAT and the edges of its input --
    out.append(phase_cat_update(torch, ops, ref, g, card, rate))
    torch.cuda.synchronize()
    return out


def cat_words(torch, g, V: int, Pc: int):
    """A CAT of V pages of Pc cards on the card: every bit a page can hold
    drawn, so a full word's top bit makes it negative as int32."""
    W = -(-Pc // 32)
    top = 2 ** 32 if Pc >= 32 * W else 2 ** (Pc - 32 * (W - 1))
    b = torch.randint(0, 2 ** 32, (V, W), generator=g, device="cuda",
                      dtype=torch.int64)
    b[:, -1] %= top
    return torch.where(b > 2 ** 31 - 1, b - 2 ** 32, b).to(torch.int32)


def cat_touch_sets(torch, g, V: int, Pc: int, R: int, past: int = 0,
                   n: int = 8) -> list:
    """``n`` lists of R vaddrs from -1 to ``past`` pages past the last, a
    quarter of them duplicates; with ``past``, four of them -1, V * Pc,
    2^31 - 1 and the last card."""
    out = []
    for _ in range(n):
        va = torch.randint(-1, (V + past) * Pc, (R,), generator=g,
                           device="cuda", dtype=torch.int32)
        va[: R // 4] = va[R // 4: R // 2]            # duplicate touches
        if past and R >= 8:
            va[R // 2: R // 2 + 4] = torch.tensor(
                [-1, V * Pc, 2 ** 31 - 1, V * Pc - 1], device="cuda",
                dtype=torch.int32)
        out.append(va)
    return out


def split_touches(torch, sets, V: int, Pc: int) -> list:
    """``sets`` with, in each, a touch on the first and the last card of
    every block's slice of every page (kernels/cat_update.CHUNK_WORDS
    words), each twice: pages split over blocks, touched in every block,
    with duplicates."""
    from repro_torch.kernels.cat_update import CHUNK_WORDS
    cards = CHUNK_WORDS * 32
    ends = []
    for v in range(V):
        for lo in range(0, Pc, cards):
            ends += [v * Pc + lo, v * Pc + min(lo + cards, Pc) - 1]
    ends = torch.tensor(ends * 2, device="cuda", dtype=torch.int32)
    check(all(va.shape[0] >= 4 + ends.shape[0] for va in sets),
          "cat_update: too few touches for the block ends")
    for va in sets:
        va[-ends.shape[0]:] = ends
    return sets


def cat_update_case(torch, ops, ref, pool, sets, Pc, tag, card,
                    rate) -> dict:
    """One cat_update case: each touch set through the kernel on
    ``pool[0]``, bit for bit against the plain version and one launch a
    call (a page wider than a block's chunk: two, the fill of its
    counters and the kernel); then the kernel's time cycling the sets on
    ``pool[0]`` (warm:
    the words stay in L2 between calls) and, given more copies of the
    words in ``pool``, cycling those too, so that every call finds its
    words in device memory (cold: the time the case reports, as the bound
    counts the words from device memory); the plain version's time and
    the bound."""
    from repro_torch.kernels.cat_update import CHUNK_WORDS
    bits = pool[0]
    V, W = bits.shape
    R = sets[0].shape[0]
    calls = 2 if W > CHUNK_WORDS else 1
    for va in sets:
        before = ops.launch_counts()["cat_update"]
        b_k, c_k = ops.cat_update(bits, va, page_objs=Pc)
        n = ops.launch_counts()["cat_update"] - before
        check(n == calls, f"cat_update {tag}: {n} launches for one call, "
                          f"{calls} wanted")
        b_p, c_p = ref.cat_update_ref(bits, va, Pc)
        check(torch.equal(b_k, b_p) and torch.equal(
            c_k.view(torch.int32), c_p.view(torch.int32)),
            f"cat_update {tag}: kernel disagrees with its plain version")
    del b_k, c_k, b_p, c_p
    pv = cycler(sets)
    warm_ms = device_ms(torch, lambda: ops.cat_update(bits, pv(),
                                                      page_objs=Pc))
    ms = warm_ms
    if len(pool) > 1:
        pb = cycler(pool)
        ms = device_ms(torch, lambda: ops.cat_update(pb(), pv(),
                                                     page_objs=Pc))
    plain_ms = device_ms(torch, lambda: ref.cat_update_ref(bits, pv(), Pc),
                         n=10, rounds=3)
    bnd = bound(8 * V * W + 4 * V + 4 * R, 2 * R + 6 * V * W, rate, PEAK_F32)
    how = (f"cold ({len(pool)} copies of the words cycled) "
           if len(pool) > 1 else "")
    log(f"[kernel] cat_update {tag} V={V} P={Pc} W={W} R={R}: equal to "
        f"plain, bits and CAR bit for bit, {calls} launch"
        f"{'es' if calls > 1 else ''} a call, on "
        f"{len(sets)} touch sets; {how}{ms * 1e3:.2f} us "
        f"({100 * bnd[0] / ms:.1f}% of the bound), warm (one copy) "
        f"{warm_ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, library "
        f"none, bound {bnd[0] * 1e3:.2f} us by {bnd[1]}) [{card}]")
    return dict(case=tag, pages=V, page_objs=Pc, words=W, touches=R, ms=ms,
                warm_ms=warm_ms, cold=len(pool) > 1, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=0.0,
                launches_per_call=calls)


def phase_cat_update(torch, ops, ref, g, card: str, rate: float) -> dict:
    """cat_update at the hybrid plane's CAT (V=3,145,728, P=8, R=1,024:
    the JSON record's time, cold) and the cases around it, each bit for
    bit against ref.cat_update_ref: touches past the last page beside -1
    and 2^31 - 1, no touches, 65,536 touches, views whose words and
    touches lie off 16 bytes (the plain loads, a ragged last chunk), 2
    words a page, every page of 1,024 touched, pages so wide that a
    chunk holds 2 of them or 1, and pages split over blocks (CAT_SPLIT:
    every block of every page touched at both ends, twice; touches past
    the end beside -1 and 2^31 - 1)."""
    i32 = torch.int32
    V, Pc, R = CAT_PAGES, CAT_CARDS, CAT_TOUCHES

    def sets(V_, Pc_, R_, past=3):
        return cat_touch_sets(torch, g, V_, Pc_, R_, past=past)

    pool = [cat_words(torch, g, V, Pc) for _ in range(CAT_COLD)]
    main = cat_update_case(torch, ops, ref, pool, sets(V, Pc, R, past=0), Pc,
                           "hybrid CAT", card, rate)
    cases = [main]
    for tag, touches in (
            ("past the end", sets(V, Pc, R)),
            ("no touches", [torch.empty((0,), device="cuda", dtype=i32)]),
            ("many touches", sets(V, Pc, CAT_MANY)),
            ("off 16 bytes", [va[1:] for va in sets(V - 1, Pc, R + 1)])):
        words = [b[1:] for b in pool] if tag == "off 16 bytes" else pool
        cases.append(cat_update_case(torch, ops, ref, words, touches, Pc,
                                     tag, card, rate))
    del pool
    Vw = V // 2                     # 2 words a page: the W=1 CAT's words
    wide = [cat_words(torch, g, Vw, CAT_WIDE_CARDS) for _ in range(CAT_COLD)]
    cases.append(cat_update_case(
        torch, ops, ref, wide, sets(Vw, CAT_WIDE_CARDS, R), CAT_WIDE_CARDS,
        "2 words a page", card, rate))
    del wide
    small = [cat_words(torch, g, CAT_SMALL_PAGES, Pc)]
    many = sets(CAT_SMALL_PAGES, Pc, CAT_MANY)
    check(all(int(torch.unique(va[(va >= 0) & (va < CAT_SMALL_PAGES * Pc)]
                               // Pc).numel()) == CAT_SMALL_PAGES
              for va in many), "cat_update: a page left untouched")
    cases.append(cat_update_case(torch, ops, ref, small, many, Pc,
                                 "every page touched", card, rate))
    for Ph, Vh in zip(CAT_HUGE_CARDS, (7, 3)):
        cases.append(cat_update_case(
            torch, ops, ref, [cat_words(torch, g, Vh, Ph)], sets(Vh, Ph, R),
            Ph, f"{Ph // 32} words a page", card, rate))
    for Vs, Ps in CAT_SPLIT:
        Ws = -(-Ps // 32)
        cases.append(cat_update_case(
            torch, ops, ref, [cat_words(torch, g, Vs, Ps)],
            split_touches(torch, sets(Vs, Ps, R), Vs, Ps), Ps,
            f"split: {Vs} page{'s' if Vs > 1 else ''} of {Ws} words",
            card, rate))
    rec = kv_record("cat_update", "src/repro_torch/kernels/csrc/cat_update.cu",
                    "src/repro/kernels/cat_update.py:55", main["ms"],
                    main["plain_ms"], None, 0.0,
                    (main["bound_ms"], main["bound_by"]))
    rec.update(warm_ms=main["warm_ms"], cases=cases)
    return rec


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
    u = fill_sparse_slab(torch, cfg, s, g)
    NP, P = cfg.num_pages, cfg.page_tokens
    qs = [(torch.randn((1, LLAMA_HEADS, cfg.head_dim), generator=g,
                       device=dev) + 4.0 * u).to(cfg.dtype)
          for _ in range(8)]
    lengths = torch.full((1,), NP * P, dtype=torch.int32, device=dev)
    return cfg, s, qs, lengths


def fill_sparse_slab(torch, cfg, s, g):
    """A sparse plane's slab from ``g``: flat pages (keys 0.1 * N(0, 1),
    values N(0, 1)) and, on a quarter of the pages, one magnet row along a
    shared direction u (returned); the page summaries to match."""
    KVH, NP, P, Dh = cfg.kv_heads, cfg.num_pages, cfg.page_tokens, \
        cfg.head_dim
    dev = g.device
    u = torch.ones((Dh,), device=dev) / Dh ** 0.5
    for h in range(KVH):
        s.k_slab[h].normal_(generator=g).mul_(0.1)
        s.v_slab[h].normal_(generator=g)
    mag = torch.randperm(NP - 1, generator=g, device=dev)[:NP // 4]
    rows = torch.randint(0, P, (mag.shape[0],), generator=g, device=dev)
    s.k_slab[:, mag, rows] = (16.0 * u).to(cfg.dtype)
    for h in range(KVH):       # one head at a time: no f32 copy of the slab
        s.kmax[h].copy_(s.k_slab[h].amax(dim=1).float())
        s.kmin[h].copy_(s.k_slab[h].amin(dim=1).float())
    return u


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


# --------------------------------------------------------------------------
# the model decode path (models.api) at full width
# --------------------------------------------------------------------------

def lm_configs(configs):
    """[lm]: llama3-8b as assigned (32 layers); [lmexpert]: kimi-k2 as
    assigned but one layer deep (61 layers of 33.8 GB expert slabs cannot
    fit one card)."""
    return (configs.get_config("llama3-8b"),
            configs.get_config("kimi-k2-1t-a32b").scaled(n_layers=1))


def kv_planes(state) -> list:
    """Every KV plane state of a serve state: one a layer, one a shared
    attention application (zamba2's ``attn_kv``), every shard of a sparse
    layer."""
    out = []
    for kv in state.kv:
        kv = kv["attn_kv"] if isinstance(kv, dict) else kv
        out += kv if isinstance(kv, list) else [kv]
    return out


def fill_kv_prefix(torch, state, g, prefix: int) -> None:
    """Every plane's frames from ``g`` (seeded K/V, as [kvdense] fills its
    plane) and ``prefix`` tokens already in context for each sequence."""
    for kv in kv_planes(state):
        for h in range(kv.k_frames.shape[0]):
            kv.k_frames[h].normal_(generator=g)
            kv.v_frames[h].normal_(generator=g)
    state.lengths.fill_(prefix)


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.nbytes


def kv_read_bytes(cfg, batch: int, tokens: int) -> int:
    """K and V of ``tokens`` rows per sequence in every layer, read once."""
    return 2 * cfg.n_layers * batch * tokens * cfg.n_kv_heads * cfg.hd * 2


def greedy_run(torch, step, params, state, tok, steps: int):
    """``steps`` greedy decode steps from ``tok``, a sync after each:
    (state, next token, ms per step)."""
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logits = step(params, state, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(dim=-1).to(torch.int32)
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    return state, tok, ms


class routing_log:
    """Within the block, every expert plane call and every dropping MoE
    router call (``mlp.route``, when given: the experts the MoE chose, from
    probabilities that bf16 router logits often tie exactly) records each
    token's top-k expert set (sorted) and the relative gap between its
    k-th and (k+1)-th router probability (how far the top-k decision is
    from a tie)."""

    def __init__(self, torch, ep, mlp=None):
        self.torch, self.ep, self.mlp, self.calls = torch, ep, mlp, []

    def _log(self, p, k, chosen=None):
        """``chosen``: the experts the call took ([rows, k]); else the
        top-k of ``p``."""
        v, i = p.sort(dim=-1, descending=True, stable=True)
        if chosen is None:
            chosen = i[:, :k]
        self.calls.append((chosen.sort(dim=-1).values,
                           (v[:, k - 1] - v[:, k]) / v[:, k - 1]))

    def __enter__(self):
        real = self.real = self.ep.moe_decode
        torch = self.torch

        def spy(cfg, s, router, x, *a, **kw):
            self._log(torch.softmax(x.float() @ router.float(), dim=-1),
                      cfg.topk)
            return real(cfg, s, router, x, *a, **kw)
        self.ep.moe_decode = spy
        if self.mlp is not None:
            real_route = self.real_route = self.mlp.route

            def route_spy(xg, router, topk):
                out = real_route(xg, router, topk)
                self._log(out[0].reshape(-1, out[0].shape[-1]), topk,
                          out[2].reshape(-1, topk))
                return out
            self.mlp.route = route_spy
        return self

    def __exit__(self, *exc):
        self.ep.moe_decode = self.real
        if self.mlp is not None:
            self.mlp.route = self.real_route


def checked_steps(torch, ep, step, step_ref, params, state, tok, n: int,
                  tag: str, mlp=None, route_tie: float = ROUTE_TIE,
                  per_row: bool = False):
    """``n`` greedy steps of the kernel path, each also run by the plain
    path (kernel_impl="ref") on a clone of the state it started from, with
    the same token: logits within LM_LOGIT_TOL of the largest |logit|.  A
    token routed to other experts by the two paths is only allowed where
    that token's top-k decision was within ``route_tie`` (relative) of a
    tie at the first layer where the paths part; its logits are then not
    compared: the whole step's (the expert plane fetches for all tokens
    together), or, with ``per_row`` (a dropping MoE whose groups hold one
    sequence each), that sequence's alone.  At least half the rows are
    compared.  Returns (state, next token, what was found)."""
    worst, agree, total, ties, compared = 0.0, 0, 0, 0, 0
    for i in range(n):
        other = state.clone()
        with routing_log(torch, ep, mlp) as rk:
            state, lk = step(params, state, tok)
        with routing_log(torch, ep, mlp) as rr:
            other, lr = step_ref(params, other, tok)
        del other
        parted = torch.zeros(lk.shape[0], dtype=torch.bool, device=lk.device)
        for (sk, mk), (sr, mr) in zip(rk.calls, rr.calls):
            diff = (sk != sr).any(dim=-1) & ~parted
            if bool(diff.any()):
                # the first layer where a token routes apart: later layers
                # see another hidden state and may part at any margin
                m = float(torch.minimum(mk, mr)[diff].max())
                check(m < route_tie, f"{tag} step {i}: the plain path routed "
                                     f"a token to other experts with a "
                                     f"top-k margin of {m:.3g}")
                parted |= diff
        if bool(parted.any()):
            ties += 1
            if not per_row:
                parted[:] = True
        keep = ~parted
        if bool(keep.any()):
            rel = float((lr - lk)[keep].abs().max() / lk.abs().max())
            check(rel <= LM_LOGIT_TOL, f"{tag} step {i}: logits of the kernel "
                                       f"path off the plain path's by "
                                       f"{rel:.3g} of the largest "
                                       f"(tolerance {LM_LOGIT_TOL})")
            worst = max(worst, rel)
        compared += int(keep.sum())
        agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
        total += lk.shape[0]
        tok = lk.argmax(dim=-1).to(torch.int32)
    check(2 * compared >= total, f"{tag}: logits compared on {compared} of "
                                 f"{total} rows (routing ties in {ties} of "
                                 f"{n} steps)")
    torch.cuda.empty_cache()
    log(f"[{tag}] {n} steps, each also through the plain path "
        f"(kernel_impl='ref') from a clone of its state: logits within "
        f"{worst:.3g} of the largest (tolerance {LM_LOGIT_TOL}) on "
        f"{compared} of {total} rows; {ties} steps with a routing tie "
        f"(top-k margin under {route_tie} where the paths first part, "
        f"{'that sequence' if per_row else 'the step'} not compared); "
        f"argmax equal for {agree} of {total}")
    return state, tok, {"logit_rel_err": worst, "argmax_agree": [agree, total],
                        "tie_steps": ties, "rows_compared": [compared, total]}


def attention_record(torch, ops, ref, kv, q, lengths, kvc, rate, card,
                     tag) -> dict:
    """paged_attention on one layer's plane at the decode step's shape,
    against its plain version, timed beside scaled_dot_product_attention
    on the same K/V gathered contiguous."""
    B, H, Dh = q.shape
    KVH, P, NP = kvc.kv_heads, kvc.page_tokens, kvc.num_pages
    table = kv.page_table[:-1].view(B, NP)
    lens = ops.lengths_to_page_lens(lengths, NP, P)
    from repro_torch.kernels import paged_attention as tpattn
    n_mma = tpattn.launches_mma
    o_k, u_k = ops.paged_attention(q, kv.k_frames, kv.v_frames, table, lens)
    check(tpattn.launches_mma == n_mma + 1,
          f"{tag}: paged_attention not on the tensor cores")
    o_p, u_p = ref.paged_attention_ref(q, kv.k_frames, kv.v_frames, table,
                                       lens)
    border = used_borderline(torch, q, kv.k_frames, kv.v_frames, table, lens)
    err, n_diff, n_border = check_attention(torch, f"{tag} paged_attention",
                                            o_k, u_k, o_p, u_p, border)
    ms = device_ms(torch, lambda: ops.paged_attention(
        q, kv.k_frames, kv.v_frames, table, lens), n=20, rounds=3)
    plain_ms = device_ms(torch, lambda: ref.paged_attention_ref(
        q, kv.k_frames, kv.v_frames, table, lens), n=5, rounds=3)
    L = int(lengths.max())
    F = kv.k_frames.shape[1] - 1
    kg = kv.k_frames[:, :F].reshape(KVH, B, NP * P, Dh)[:, :, :L].transpose(
        0, 1).contiguous()
    vg = kv.v_frames[:, :F].reshape(KVH, B, NP * P, Dh)[:, :, :L].transpose(
        0, 1).contiguous()
    lib_ms = device_ms(torch, sdpa_fn(torch, q, kg, vg), n=20, rounds=3)
    del kg, vg
    G = H // KVH
    nb = 2 * B * KVH * L * Dh * 2 + 2 * B * H * Dh * 2 + B * NP * P \
        + 8 * B * NP
    bnd = bound(nb, 4 * G * Dh * L * KVH * B, rate, PEAK_BF16)
    log(f"[{tag}] paged_attention at the step's shape (B={B}, G={G}, "
        f"Dh={Dh}, {L} tokens, bf16): max abs err {err:.3g} (tolerance 2e-2 "
        f"x the largest output), used differs on {n_diff} rows, {n_border} "
        f"borderline; {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
        f"library scaled_dot_product_attention on K/V gathered contiguous "
        f"{lib_ms * 1e3:.2f} us, bound {bnd[0] * 1e3:.2f} us by {bnd[1]}) "
        f"[{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err}


def profile_steps(torch, step, params, state, tok, n, card, tag):
    """``n`` decode steps under torch.profiler: wall and device busy time
    per step, device operations per step, the heaviest kernels."""
    box = [state]

    def one():
        box[0], _ = step(params, box[0], tok)
    wall, busy, ops_n, rows = profiled(torch, one, n)
    log(f"[{tag}] profile of {n} steps: wall {wall * 1e3:.3f} ms/step, "
        f"device busy {busy * 1e3:.3f} ms/step ({100 * busy / wall:.1f}% of "
        f"wall), {ops_n:.0f} device ops/step [{card}]")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[{tag}]   {dev_us / 1e3 / n:8.3f} ms/step {count / n:6.1f} "
            f"per step  {key[:90]}")
    return box[0], {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
                    "ops_per_step": ops_n}


def nosync_steps(torch, step, params, state, tok, n, tag):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            state, logits = step(params, state, tok)
            tok = logits.argmax(dim=-1).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    log(f"[{tag}] {n} more steps under set_sync_debug_mode('error'): no "
        f"host sync")
    return state


def phase_lm(torch, ops, ref, configs, api, ep, card: str,
             rate: float) -> dict:
    """llama3-8b at full width and depth through api.decode_step: 8
    sequences with 2,048 seeded tokens of context each, 32 greedy steps."""
    dev = torch.device("cuda")
    cfg = lm_configs(configs)[0]
    shape = configs.ShapeConfig("serve", LM_SEQ, LM_BATCH, "decode")
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 6, device=dev)
    state = api.init_decode_state(cfg, shape, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    fill_kv_prefix(torch, state, g, LM_PREFIX)
    torch.cuda.synchronize()
    kvc, mode = api.kv_plan(cfg, shape)
    log(f"[lm] llama3-8b {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, bf16: weights {nbytes(params) / 1e9:.2f} GB, {mode} "
        f"KV planes {nbytes([[k.k_frames, k.v_frames] for k in state.kv]) / 1e9:.2f}"
        f" GB ({cfg.n_layers} x {tuple(state.kv[0].k_frames.shape)} x2), "
        f"{LM_PREFIX} tokens of context x {LM_BATCH} sequences; set up in "
        f"{time.time() - t0:.1f}s")
    step = api.decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    ops.reset_launch_counts()
    state, tok, ms = greedy_run(torch, step, params, state, tok, LM_STEPS)
    launches = ops.launch_counts()
    want = cfg.n_layers * LM_STEPS
    check(launches["paged_attention"] == want
          and launches["paged_attention_mma"] == want,
          f"[lm] paged_attention launched {launches['paged_attention']} "
          f"times ({launches['paged_attention_mma']} on the tensor cores) "
          f"in {LM_STEPS} steps of {cfg.n_layers} layers")
    check(bool((state.lengths == LM_PREFIX + LM_STEPS).all()),
          f"[lm] lengths {state.lengths.tolist()} after {LM_STEPS} steps")
    step_ms = statistics.median(ms[1:])
    w_bytes = nbytes(params) - params["embed"].nbytes \
        + LM_BATCH * cfg.d_model * 2
    kv_bytes = kv_read_bytes(cfg, LM_BATCH, LM_PREFIX + LM_STEPS // 2)
    bnd = bound(w_bytes + kv_bytes, 2 * LM_BATCH * (w_bytes / 2), rate,
                PEAK_BF16)
    log(f"[lm] {LM_STEPS} greedy steps: {step_ms:.3f} ms per step (median, "
        f"synced; first {ms[0]:.3f} ms); lengths {LM_PREFIX + LM_STEPS}; "
        f"launches {launches} ({want // LM_STEPS} paged_attention per step); "
        f"step bound {bnd[0]:.3f} ms by {bnd[1]} (weights read once, the "
        f"embedding indexed, {w_bytes / 1e9:.2f} GB, plus K/V "
        f"{kv_bytes / 1e9:.2f} GB) [{card}]")
    state, tok, vs_plain = checked_steps(
        torch, ep, step, api.decode_step(cfg, shape, kernel_impl="ref"),
        params, state, tok, LM_CHECKED, "lm")
    state, prof = profile_steps(torch, step, params, state, tok, LM_PROFILE,
                                card, "lm")
    state = nosync_steps(torch, step, params, state, tok, LM_NOSYNC, "lm")
    q = torch.randn((LM_BATCH, cfg.n_heads, cfg.hd), generator=g,
                    device=dev, dtype=cfg.dtype)
    attn = attention_record(torch, ops, ref, state.kv[0], q, state.lengths,
                            kvc, rate, card, "lm")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "first_ms": ms[0],
            "bound_ms": bnd[0], "vs_plain": vs_plain, "profile": prof,
            "attention": attn}


def resident_match(torch, epc, es, mp) -> int:
    """Every resident slot's hot weights equal its expert's slab rows."""
    S = epc.hot_slots
    e = es.view("expert_of")
    held = torch.nonzero(e >= 0).flatten()
    ids = e[held].long()
    for name, slab in (("hot_wi", mp["wi"]), ("hot_wg", mp["wg"]),
                       ("hot_wo", mp["wo"])):
        check(torch.equal(getattr(es, name)[:S][held], slab[ids]),
              f"[lmexpert] {name}: a resident slot differs from its "
              f"expert's slab rows")
    check(torch.equal(es.view("slot_of")[ids], held.to(torch.int32)),
          "[lmexpert] slot_of and expert_of disagree")
    return int(held.numel())


def phase_lm_expert(torch, ops, ref, configs, api, ep, convert, card: str,
                    rate: float) -> dict:
    """kimi-k2 at full width, one layer deep, through api.decode_step and
    the expert plane (384 experts, 32 hot slots, fetch budget 8): 8
    sequences with 2,048 seeded tokens of context, 32 greedy steps."""
    dev = torch.device("cuda")
    cfg = lm_configs(configs)[1]
    shape = configs.ShapeConfig("serve", LM_SEQ, LM_BATCH, "decode")
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 8, device=dev)
    state = api.init_decode_state(cfg, shape, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    fill_kv_prefix(torch, state, g, LM_PREFIX)
    torch.cuda.synchronize()
    epc = api._expert_cfg(cfg)
    mp = params["blocks"][0]["moe"]
    es = state.extra[0]
    hot = es.hot_wi.nbytes + es.hot_wg.nbytes + es.hot_wo.nbytes
    log(f"[lmexpert] kimi-k2 1 of {configs.get_config('kimi-k2-1t-a32b').n_layers}"
        f" layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads (Dh {cfg.hd}), {cfg.moe_experts} experts top-{cfg.moe_topk}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16: expert slabs "
        f"{nbytes([mp['wi'], mp['wg'], mp['wo']]) / 1e9:.2f} GB, hot store "
        f"{epc.hot_slots} slots + trash {hot / 1e9:.2f} GB, other weights "
        f"{(nbytes(params) - nbytes([mp['wi'], mp['wg'], mp['wo']])) / 1e9:.2f}"
        f" GB; set up in {time.time() - t0:.1f}s")
    step = api.decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    ops.reset_launch_counts()
    fetched0 = int((es.view("expert_of") >= 0).sum())
    state, tok, ms = greedy_run(torch, step, params, state, tok, LM_STEPS)
    launches = ops.launch_counts()
    check(launches["gather_rows"] == 3 * LM_STEPS
          and launches["gather_rows_into"] == 3 * LM_STEPS,
          f"[lmexpert] gather_rows launched {launches['gather_rows']} times "
          f"({launches['gather_rows_into']} in place) in {LM_STEPS} steps "
          f"(3 per step wanted, all in place)")
    check(launches["paged_attention"] == LM_STEPS
          and launches["paged_attention_mma"] == LM_STEPS,
          f"[lmexpert] paged_attention launches {launches}")
    check(int(es.step) == LM_STEPS and fetched0 == 0,
          "[lmexpert] the expert plane's step count is off")
    access = es.access
    needed_per_step = float(access.sum()) / LM_STEPS
    held = resident_match(torch, epc, es, mp)
    check(held == epc.hot_slots, f"[lmexpert] {held} of {epc.hot_slots} "
                                 f"slots hold an expert")
    step_ms = statistics.median(ms[1:])
    log(f"[lmexpert] {LM_STEPS} greedy steps: {step_ms:.3f} ms per step "
        f"(median, synced; first {ms[0]:.3f} ms); {needed_per_step:.1f} "
        f"experts needed per step on average, {held} resident, all equal "
        f"to their slab rows; launches {launches} [{card}]")
    state, tok, vs_plain = checked_steps(
        torch, ep, step, api.decode_step(cfg, shape, kernel_impl="ref"),
        params, state, tok, LM_CHECKED, "lmexpert")

    # the batch executor against the reference executor, 2 steps on a clone
    step_r = api.decode_step(cfg, shape, fetch_mode="reference")
    for _ in range(2):
        other = state.clone()
        state, lb = step(params, state, tok)
        other, lr = step_r(params, other, tok)
        a = convert.expert_state_to_numpy(state.extra[0])
        b = convert.expert_state_to_numpy(other.extra[0])
        for k in a:
            check(bool((a[k] == b[k]).all()),
                  f"[lmexpert] batch vs reference executor: {k} differs")
        check(torch.equal(lb, lr), "[lmexpert] batch vs reference executor: "
                                   "logits differ")
        tok = lb.argmax(dim=-1).to(torch.int32)
        del other
    torch.cuda.empty_cache()
    log("[lmexpert] batch == reference executor over 2 steps on a clone: "
        "every expert plane field, the hot store and the logits bit for bit")

    state, prof = profile_steps(torch, step, params, state, tok, LM_PROFILE,
                                card, "lmexpert")
    state = nosync_steps(torch, step, params, state, tok, LM_NOSYNC,
                         "lmexpert")
    resident_match(torch, epc, state.extra[0], mp)

    # paged_attention at Dh 112 (G=8) on the layer's plane
    q = torch.randn((LM_BATCH, cfg.n_heads, cfg.hd), generator=g,
                    device=dev, dtype=cfg.dtype)
    kvc, _ = api.kv_plan(cfg, shape)
    attn = attention_record(torch, ops, ref, state.kv[0], q, state.lengths,
                            kvc, rate, card, "lmexpert")

    # gather_rows at the expert fetch's shape: 8 rows of d*f bf16
    E, D = cfg.moe_experts, cfg.d_model * cfg.d_ff
    pool = mp["wi"].view(E, D)
    sets = [torch.randperm(E, generator=g, device=dev)[:epc.fetch_budget].to(
        torch.int32) for _ in range(4)]
    check(torch.equal(ops.gather_rows(pool, sets[0]),
                      ref.gather_rows_ref(pool, sets[0])),
          "[lmexpert] gather_rows disagrees with its plain version at the "
          "expert shape")
    pick = cycler(sets)
    # the kernel and index_select in turns (kernel, library, library,
    # kernel): at these sizes the first of several timings in a row reads
    # a few us slow, so each reports the mean of its two turns
    turns = {"kernel": [], "library": []}
    for who in ("kernel", "library", "library", "kernel"):
        fn = ((lambda: ops.gather_rows(pool, pick())) if who == "kernel" else
              (lambda: pool.index_select(0, pick().long())))
        turns[who].append(device_ms(torch, fn, n=10, rounds=3))
    g_ms = sum(turns["kernel"]) / 2
    gl_ms = sum(turns["library"]) / 2
    gp_ms = device_ms(torch, lambda: ref.gather_rows_ref(pool, pick()), n=10,
                      rounds=3)
    R = epc.fetch_budget
    gb = 2 * R * D * pool.element_size() + 4 * R
    g_bnd = bound(gb, 0, rate, PEAK_BF16)
    log(f"[kernel] gather_rows at the expert fetch (R={R} rows of "
        f"{D * pool.element_size() / 1e6:.2f} MB, bf16; plan "
        f"{plan_of(pool, sets[0])}): equal to plain; "
        f"{g_ms * 1e3:.2f} us (plain {gp_ms * 1e3:.2f} us, library "
        f"index_select {gl_ms * 1e3:.2f} us, bound {g_bnd[0] * 1e3:.2f} us "
        f"by bytes, {100 * g_bnd[0] / g_ms:.0f}% of it; in turns kernel "
        f"{turns['kernel'][0] * 1e3:.2f}, index_select "
        f"{turns['library'][0] * 1e3:.2f}, "
        f"{turns['library'][1] * 1e3:.2f}, kernel "
        f"{turns['kernel'][1] * 1e3:.2f} us) [{card}]")

    # gather_rows_into at the expert fetch's shape: a plan's 8 entries, two
    # of them masked (expert 0's row onto the trash slot, as the fetch
    # writes them), into a clone of the hot store's wi
    S = epc.hot_slots
    plans = []
    for i in range(4):
        e = sets[i].clone()
        e[1::4] = -1
        slot = torch.randperm(S, generator=g, device=dev)[:R].to(torch.int32)
        plans.append((torch.where(e >= 0, slot, S).to(torch.int32),
                      e.clamp_min(0)))
    a = es.hot_wi.view(S + 1, D).clone()
    b = a.clone()
    ops.gather_rows_into(a, plans[0][0], pool, plans[0][1])
    ref.gather_rows_into_ref(b, plans[0][0], pool, plans[0][1])
    check(torch.equal(a, b), "[lmexpert] gather_rows_into disagrees with its "
                             "plain version at the expert shape (trash slot "
                             "included)")
    del b
    pick_p = cycler(plans)
    i_ms = device_ms(torch, lambda: ops.gather_rows_into(
        a, *dst_pool_idx(pick_p(), pool)), n=10, rounds=3)
    ip_ms = device_ms(torch, lambda: ref.gather_rows_into_ref(
        a, *dst_pool_idx(pick_p(), pool)), n=10, rounds=3)

    def two_step():
        d, i = pick_p()
        a.index_put_((d.long(),), pool.index_select(0, i.long()))
    il_ms = device_ms(torch, two_step, n=10, rounds=3)
    del a
    log(f"[kernel] gather_rows_into at the expert fetch ({R} entries, 2 "
        f"onto the trash slot): equal to plain, trash slot included; "
        f"{i_ms * 1e3:.2f} us (plain {ip_ms * 1e3:.2f} us, index_select + "
        f"index_put_ {il_ms * 1e3:.2f} us, bound {g_bnd[0] * 1e3:.2f} us) "
        f"[{card}]")

    # the whole fetch of one step (3 gathers straight into the hot store)
    # on a clone of the plane, replaying one plan of 8 misses
    ex = es.clone()
    needed = torch.zeros((E,), dtype=torch.bool, device=dev)
    needed[torch.randperm(E, generator=g, device=dev)[:60]] = True
    plan = ep.plan_fetch(epc, ex, needed)
    n_fetch = int((plan.expert >= 0).sum())
    src = ep._slab_sources(plan, (mp["wi"], mp["wg"], mp["wo"]))
    f_ms = device_ms(torch, lambda: ep._exec_fetch_batch(epc, ex, plan, src),
                     n=10, rounds=3)
    fb = 3 * 2 * n_fetch * D * 2
    f_bnd = bound(fb, 0, rate, PEAK_BF16)
    del ex
    log(f"[lmexpert] expert fetch of one step ({n_fetch} experts, 3 "
        f"tensors, gather_rows_into the hot store): {f_ms:.3f} ms "
        f"device time; bound {f_bnd[0]:.3f} ms by bytes (each fetched row "
        f"read once and written once into its slot) [{card}]")

    w_bytes = (nbytes(params) - nbytes([mp["wi"], mp["wg"], mp["wo"]])
               - params["embed"].nbytes + LM_BATCH * cfg.d_model * 2
               + 3 * epc.hot_slots * D * 2)
    kv_bytes = kv_read_bytes(cfg, LM_BATCH, LM_PREFIX + LM_STEPS // 2)
    s_bnd = bound(w_bytes + kv_bytes + fb, 0, rate, PEAK_BF16)
    log(f"[lmexpert] step bound {s_bnd[0]:.3f} ms by bytes (weights but "
        f"the slabs, the embedding indexed, the whole hot store "
        f"{w_bytes / 1e9:.2f} GB; K/V {kv_bytes / 1e9:.3f} GB; the fetch "
        f"{fb / 1e9:.2f} GB) against {step_ms:.3f} ms [{card}]")
    del params, state, pool, es, mp
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "first_ms": ms[0],
            "bound_ms": s_bnd[0], "vs_plain": vs_plain, "profile": prof,
            "attention": attn,
            "experts_needed_per_step": needed_per_step,
            "fetch_ms": f_ms, "fetch_bound_ms": f_bnd[0],
            "gather": {"ms": g_ms, "plain_ms": gp_ms, "library_ms": gl_ms,
                       "bound_ms": g_bnd[0], "max_abs_err": 0.0,
                       "row_bytes": D * 2, "rows": R,
                       "into_ms": i_ms, "into_plain_ms": ip_ms,
                       "into_two_step_ms": il_ms}}


def to_device(tree, dev):
    """A params or state tree (dicts, lists, tuples of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev)


def to_float(torch, tree):
    """A params tree with every floating tensor in f32."""
    if isinstance(tree, dict):
        return {k: to_float(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_float(torch, v) for v in tree)
    return tree.float() if tree.is_floating_point() else tree


def rest_configs(configs):
    """[lmmoe] mixtral-8x7b cut to 16 of its 32 layers (32 layers of bf16
    weights take ~93 GB); [lmssm] xlstm-350m, [lmhybrid] zamba2-1.2b and
    [lmencdec] seamless-m4t-medium as assigned."""
    return (configs.get_config("mixtral-8x7b").scaled(n_layers=MOE_LAYERS),
            configs.get_config("xlstm-350m"),
            configs.get_config("zamba2-1.2b"),
            configs.get_config("seamless-m4t-medium"))


def lm_header(tag, cfg, params, extra: str, t0: float) -> None:
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads (Dh {cfg.hd}), d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, bf16: weights "
        f"{nbytes(params) / 1e9:.2f} GB, {extra}; set up in "
        f"{time.time() - t0:.1f}s")


def counted_run(torch, ops, step, params, state, tok, steps: int, tag: str,
                want: dict):
    """``steps`` timed greedy steps with the launch counts set to 0 just
    before and read just after; each kernel of ``want`` launched exactly
    that many times a step (every bf16 paged_attention launch on the
    tensor cores), every other kernel never."""
    ops.reset_launch_counts()
    state, tok, ms = greedy_run(torch, step, params, state, tok, steps)
    launches = ops.launch_counts()
    per = {k: v / steps for k, v in launches.items()}
    for k in ("gather_rows", "compact_pages", "cat_decay", "page_scores",
              "paged_attention", "cat_update"):
        check(launches[k] == want.get(k, 0) * steps,
              f"[{tag}] {k} launched {launches[k]} times in {steps} steps, "
              f"{want.get(k, 0)} a step wanted: {launches}")
    check(launches["paged_attention_mma"] == launches["paged_attention"],
          f"[{tag}] {launches['paged_attention_mma']} of "
          f"{launches['paged_attention']} paged_attention launches on the "
          f"tensor cores")
    log(f"[{tag}] launches per step {per}")
    return state, tok, ms, launches


def phase_lm_moe(torch, ops, ref, configs, api, ep, mlp, card: str,
                 rate: float) -> dict:
    """mixtral-8x7b at full width, 16 layers deep, through the dropping
    MoE: decode (8 sequences, 2,048 seeded tokens of context in the dense
    plane), then decode_long through the window plane (one sequence from
    4,088 tokens, across the ring's wrap at 4,096)."""
    dev = torch.device("cuda")
    cfg = rest_configs(configs)[0]
    shape = configs.ShapeConfig("serve", LM_SEQ, LM_BATCH, "decode")
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 10, device=dev)
    state = api.init_decode_state(cfg, shape, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 11)
    fill_kv_prefix(torch, state, g, LM_PREFIX)
    torch.cuda.synchronize()
    experts = sum(nbytes([b["moe"]["wi"], b["moe"]["wg"], b["moe"]["wo"]])
                  for b in params["blocks"])
    lm_header("lmmoe", cfg, params,
              f"{cfg.moe_experts} experts top-{cfg.moe_topk} "
              f"({experts / 1e9:.2f} GB of experts), depth cut to "
              f"{cfg.n_layers} of {configs.get_config(cfg.name).n_layers} "
              f"layers; dense KV planes "
              f"{nbytes([[k.k_frames, k.v_frames] for k in state.kv]) / 1e9:.2f}"
              f" GB, {LM_PREFIX} tokens of context x {LM_BATCH} sequences",
              t0)
    step = api.decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    state, tok, ms, launches = counted_run(
        torch, ops, step, params, state, tok, REST_STEPS, "lmmoe",
        {"paged_attention": cfg.n_layers})
    check(bool((state.lengths == LM_PREFIX + REST_STEPS).all()),
          f"[lmmoe] lengths {state.lengths.tolist()}")
    step_ms = statistics.median(ms[1:])
    # every expert's weights are read: the batched expert products run
    # over all 8 experts' capacity slots (8 groups of 1 token, Cg 4)
    w_bytes = nbytes(params) - params["embed"].nbytes \
        + LM_BATCH * cfg.d_model * 2
    G = LM_BATCH
    Cg = 4
    flops = 2 * LM_BATCH * (w_bytes - experts) / 2 \
        + 2 * G * Cg * experts / 2
    kv_bytes = kv_read_bytes(cfg, LM_BATCH, LM_PREFIX + REST_STEPS // 2)
    bnd = bound(w_bytes + kv_bytes, flops, rate, PEAK_BF16)
    log(f"[lmmoe] {REST_STEPS} greedy steps: {step_ms:.3f} ms per step "
        f"(median, synced; first {ms[0]:.3f} ms); step bound {bnd[0]:.3f} ms "
        f"by {bnd[1]} (weights read once, every expert, the embedding "
        f"indexed, {w_bytes / 1e9:.2f} GB, plus K/V {kv_bytes / 1e9:.2f} GB)"
        f" [{card}]")
    step_ref = api.decode_step(cfg, shape, kernel_impl="ref")
    state, tok, vs_plain = checked_steps(torch, ep, step, step_ref, params,
                                         state, tok, MOE_CHECKED, "lmmoe",
                                         mlp=mlp, route_tie=MOE_ROUTE_TIE,
                                         per_row=True)
    state, prof = profile_steps(torch, step, params, state, tok, LM_PROFILE,
                                card, "lmmoe")
    state = nosync_steps(torch, step, params, state, tok, REST_NOSYNC,
                         "lmmoe")
    del state
    torch.cuda.empty_cache()

    # decode_long: the window plane (a ring of 64 pages) across the wrap
    lshape = configs.ShapeConfig("long", LONG_SEQ, 1, "decode_long")
    kvc, mode = api.kv_plan(cfg, lshape)
    check(mode == "window", f"[lmmoe] decode_long took the {mode} plane")
    W = kvc.num_pages * kvc.page_tokens
    state = api.init_decode_state(cfg, lshape, device=dev)
    fill_kv_prefix(torch, state, g, WINDOW_FROM)
    lstep = api.decode_step(cfg, lshape)
    tok = tok[:1].clone()
    state, tok, lms, llaunch = counted_run(
        torch, ops, lstep, params, state, tok, WINDOW_TIMED, "lmmoe",
        {"paged_attention": cfg.n_layers})
    state, tok, lvs = checked_steps(
        torch, ep, lstep, api.decode_step(cfg, lshape, kernel_impl="ref"),
        params, state, tok, WINDOW_CHECKED, "lmmoe", mlp=mlp,
        route_tie=MOE_ROUTE_TIE, per_row=True)
    end = WINDOW_FROM + WINDOW_TIMED + WINDOW_CHECKED
    check(int(state.lengths[0]) == end and end > W,
          f"[lmmoe] window run ended at {int(state.lengths[0])} tokens")
    l_ms = statistics.median(lms[1:])
    l_bnd = bound(w_bytes - (LM_BATCH - 1) * cfg.d_model * 2
                  + kv_read_bytes(cfg, 1, W), 2 * Cg * experts / 2, rate,
                  PEAK_BF16)
    log(f"[lmmoe] decode_long through the window plane ({kvc.num_pages} "
        f"pages of {kvc.page_tokens}, window {W}), one sequence from "
        f"{WINDOW_FROM} tokens: {WINDOW_TIMED} timed steps at {l_ms:.3f} ms "
        f"(median; bound {l_bnd[0]:.3f} ms by {l_bnd[1]}, every expert read "
        f"as at B 8), then {WINDOW_CHECKED} checked steps across the wrap "
        f"at {W}, lengths {end} [{card}]")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "window_launches": llaunch,
            "step_ms": step_ms, "first_ms": ms[0], "bound_ms": bnd[0],
            "vs_plain": vs_plain, "profile": prof, "window_step_ms": l_ms,
            "window_bound_ms": l_bnd[0], "window_vs_plain": lvs}


def phase_lm_ssm(torch, ops, configs, api, card: str, rate: float) -> dict:
    """xlstm-350m at full width and depth, batch 128 (decode_32k's batch):
    16 timed greedy steps from a fresh state (no kernel on this path);
    then 2 of the sequences for 4 more steps on the card and on the CPU,
    from the same weights and state copied to the host."""
    dev = torch.device("cuda")
    cfg = rest_configs(configs)[1]
    shape = configs.ShapeConfig("serve", 32768, SSM_BATCH, "decode")
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 12, device=dev)
    state = api.init_decode_state(cfg, shape, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 13)
    torch.cuda.synchronize()
    st_bytes = nbytes(state.kv)
    lm_header("lmssm", cfg, params,
              f"{api._n_groups(cfg)} (mLSTM, sLSTM) groups, recurrent state "
              f"{st_bytes / 1e9:.2f} GB f32 for {SSM_BATCH} sequences", t0)
    step = api.decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab, (SSM_BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    state, tok, ms, launches = counted_run(torch, ops, step, params, state,
                                           tok, REST_STEPS, "lmssm", {})
    step_ms = statistics.median(ms[1:])
    w_bytes = nbytes(params) - params["embed"].nbytes \
        + SSM_BATCH * cfg.d_model * 2
    bnd = bound(w_bytes + 2 * st_bytes, 2 * SSM_BATCH * w_bytes / 2, rate,
                PEAK_BF16)
    log(f"[lmssm] {REST_STEPS} greedy steps: {step_ms:.3f} ms per step "
        f"(median, synced; first {ms[0]:.3f} ms); step bound {bnd[0]:.3f} ms "
        f"by {bnd[1]} (weights {w_bytes / 1e9:.2f} GB read once, the "
        f"recurrent state {st_bytes / 1e9:.2f} GB read and written) [{card}]")

    # the card against the CPU: 2 sequences, 4 steps, the same tokens, in
    # f32 (the bf16 weights cast up, exact) and in bf16.  A bf16 xLSTM 24
    # blocks deep moves its logits by about 5e-2 of the largest with any
    # change of summation order, so f32 holds the card's arithmetic
    # tightly, and the bf16 main path is held to the f32 answer no worse
    # than the larger of LM_LOGIT_TOL and twice the CPU's bf16 distance
    n = SSM_CPU_SEQS
    cpu = torch.device("cpu")
    cfg32 = cfg.scaled(dtype=torch.float32)
    cshape = configs.ShapeConfig("cpu", 32768, n, "decode")
    params32 = to_float(torch, params)
    cparams = to_device(params, cpu)
    cparams32 = to_float(torch, cparams)
    cstate = api.ServeState(
        state.lengths[:n].cpu(),
        [to_device({k: (tuple(t[:n] for t in v) if isinstance(v, tuple)
                        else v[:n]) for k, v in gs.items()}, cpu)
         for gs in state.kv], ())
    cstate32, state32 = cstate.clone(), state.clone()
    cstep, cstep32 = (api.decode_step(cfg, cshape),
                      api.decode_step(cfg32, cshape))
    step32 = api.decode_step(cfg32, shape)
    w32 = w_card = w_cpu = 0.0
    t1 = time.time()
    for i in range(SSM_CPU_STEPS):
        state, lk = step(params, state, tok)
        state32, lk32 = step32(params32, state32, tok)
        cstate, lc = cstep(cparams, cstate, tok[:n].cpu())
        cstate32, lc32 = cstep32(cparams32, cstate32, tok[:n].cpu())
        top = float(lc32.abs().max())
        e32 = float((lk32[:n].cpu() - lc32).abs().max()) / top
        check(e32 <= SSM_F32_TOL, f"[lmssm] step {i}: the card's f32 logits "
                                  f"off the CPU's by {e32:.3g} of the "
                                  f"largest (tolerance {SSM_F32_TOL})")
        w32 = max(w32, e32)
        w_card = max(w_card, float((lk[:n].cpu().float() - lc32).abs().max())
                     / top)
        w_cpu = max(w_cpu, float((lc.float() - lc32).abs().max()) / top)
        tok = lk.argmax(dim=-1).to(torch.int32)
    lim = max(LM_LOGIT_TOL, 2 * w_cpu)
    check(w_card <= lim, f"[lmssm] the card's bf16 logits off the f32 answer "
                         f"by {w_card:.3g} of the largest, the CPU's bf16 by "
                         f"{w_cpu:.3g} (limit {lim:.3g})")
    log(f"[lmssm] {SSM_CPU_STEPS} steps of {n} sequences on the card and on "
        f"the CPU ({time.time() - t1:.1f}s) from the same weights and state: "
        f"f32 logits within {w32:.3g} of the largest (tolerance "
        f"{SSM_F32_TOL}); bf16 off the f32 answer by {w_card:.3g} on the "
        f"card and {w_cpu:.3g} on the CPU (limit {lim:.3g})")
    del cparams, cstate, cparams32, cstate32, params32, state32
    state, prof = profile_steps(torch, step, params, state, tok, LM_PROFILE,
                                card, "lmssm")
    state = nosync_steps(torch, step, params, state, tok, REST_NOSYNC,
                         "lmssm")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "first_ms": ms[0],
            "bound_ms": bnd[0], "vs_cpu_f32": w32, "bf16_vs_f32_card": w_card,
            "bf16_vs_f32_cpu": w_cpu, "profile": prof}


def seed_mamba(torch, st: dict, g) -> None:
    """Mamba2 conv and SSM states from ``g`` (N(0, 1)), as a context would
    leave them."""
    for t in st["conv"] + st["ssm"]:
        t.normal_(generator=g)


def phase_lm_hybrid(torch, ops, ref, configs, api, ep, card: str,
                    rate: float) -> dict:
    """zamba2-1.2b at full width and depth: decode (8 sequences, 2,048
    seeded tokens of context in each group's dense plane), then long_500k
    (one sequence from 524,224 tokens, each group's sparse plane filled
    as [kvsparse] fills one)."""
    dev = torch.device("cuda")
    cfg = rest_configs(configs)[2]
    shape = configs.ShapeConfig("serve", LM_SEQ, LM_BATCH, "decode")
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 14, device=dev)
    state = api.init_decode_state(cfg, shape, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 15)
    fill_kv_prefix(torch, state, g, LM_PREFIX)
    for gs in state.kv + [state.extra]:
        seed_mamba(torch, gs, g)
    torch.cuda.synchronize()
    planes = kv_planes(state)
    lm_header("lmhybrid", cfg, params,
              f"6 groups of 5 Mamba2 blocks + the shared attention, 2 tail "
              f"blocks; {len(planes)} dense KV planes "
              f"{nbytes([[k.k_frames, k.v_frames] for k in planes]) / 1e9:.2f}"
              f" GB, {LM_PREFIX} tokens of context x {LM_BATCH} sequences",
              t0)
    step = api.decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    state, tok, ms, launches = counted_run(
        torch, ops, step, params, state, tok, REST_STEPS, "lmhybrid",
        {"paged_attention": 6})
    step_ms = statistics.median(ms[1:])
    w_bytes = nbytes(params) - params["embed"].nbytes \
        + LM_BATCH * cfg.d_model * 2
    ssm_bytes = nbytes([gs["ssm"] + gs["conv"]
                        for gs in state.kv + [state.extra]])
    kv_bytes = 6 * 2 * LM_BATCH * (LM_PREFIX + REST_STEPS // 2) \
        * cfg.n_kv_heads * cfg.hd * 2
    bnd = bound(w_bytes + kv_bytes + 2 * ssm_bytes,
                2 * LM_BATCH * w_bytes / 2, rate, PEAK_BF16)
    log(f"[lmhybrid] {REST_STEPS} greedy steps: {step_ms:.3f} ms per step "
        f"(median, synced; first {ms[0]:.3f} ms); step bound {bnd[0]:.3f} ms "
        f"by {bnd[1]} (weights {w_bytes / 1e9:.2f} GB with the shared block "
        f"once, K/V {kv_bytes / 1e9:.2f} GB, Mamba2 states "
        f"{ssm_bytes / 1e9:.3f} GB read and written) [{card}]")
    state, tok, vs_plain = checked_steps(
        torch, ep, step, api.decode_step(cfg, shape, kernel_impl="ref"),
        params, state, tok, REST_CHECKED, "lmhybrid")
    state, prof = profile_steps(torch, step, params, state, tok, LM_PROFILE,
                                card, "lmhybrid")
    state = nosync_steps(torch, step, params, state, tok, REST_NOSYNC,
                         "lmhybrid")
    kvc, _ = api.kv_plan(cfg, shape)
    q = torch.randn((LM_BATCH, cfg.n_heads, cfg.hd), generator=g,
                    device=dev, dtype=cfg.dtype)
    attn = attention_record(torch, ops, ref, state.kv[0]["attn_kv"], q,
                            state.lengths, kvc, rate, card, "lmhybrid")
    del state, planes
    torch.cuda.empty_cache()

    # long_500k: each group's sparse plane, one shard
    lshape = configs.ShapeConfig("long", LONG_SEQ, 1, "decode_long")
    lkvc, mode = api.kv_plan(cfg, lshape)
    check(mode == "sparse", f"[lmhybrid] long_500k took the {mode} plane")
    t0 = time.time()
    state = api.init_decode_state(cfg, lshape, device=dev)
    for gs in state.kv:
        fill_sparse_slab(torch, lkvc, gs["attn_kv"][0], g)
    for gs in state.kv + [state.extra]:
        seed_mamba(torch, gs, g)
    state.lengths.fill_(LONG_FROM)
    torch.cuda.synchronize()
    planes = kv_planes(state)
    log(f"[lmhybrid] long_500k: {len(planes)} sparse planes, slab "
        f"{tuple(planes[0].k_slab.shape)} bf16 x2 each "
        f"({nbytes([[k.k_slab, k.v_slab] for k in planes]) / 1e9:.2f} GB in "
        f"all), top-{lkvc.sparse_topk} of {lkvc.num_frames} frames, fetch "
        f"budget {lkvc.fetch_budget}, from {LONG_FROM} tokens; filled in "
        f"{time.time() - t0:.1f}s")
    lstep = api.decode_step(cfg, lshape)
    tok = tok[:1].clone()
    # the sparse step attends with plain tensor code (JAX's partial
    # attention is plain jnp), so paged_attention is not on this path
    state, tok, lms, llaunch = counted_run(
        torch, ops, lstep, params, state, tok, REST_STEPS, "lmhybrid",
        {"page_scores": 6, "gather_rows": 12})
    l_ms = statistics.median(lms[1:])
    whole, packed = check_frames_hold_slab(torch, lkvc, planes[0])
    slab_bytes = 6 * 2 * lkvc.kv_heads * lkvc.sparse_topk * lkvc.page_tokens \
        * lkvc.head_dim * 2
    sum_bytes = 6 * 2 * planes[0].kmax.nbytes
    lbnd = bound(w_bytes + slab_bytes + sum_bytes, 2 * w_bytes / 2, rate,
                 PEAK_BF16)
    log(f"[lmhybrid] long_500k {REST_STEPS} greedy steps: {l_ms:.3f} ms per "
        f"step (median, synced; first {lms[0]:.3f} ms); gather_rows "
        f"{llaunch['gather_rows'] / REST_STEPS:.0f} a step (K and V of each "
        f"of the 6 fetching planes), page_scores "
        f"{llaunch['page_scores'] / REST_STEPS:.0f}; step bound "
        f"{lbnd[0]:.3f} ms by {lbnd[1]} (weights, the 64 selected pages "
        f"and the summaries of each plane); plane 0 frames hold their slab "
        f"rows ({whole} whole, {packed} packed) [{card}]")
    state, tok, lvs = checked_steps(
        torch, ep, lstep, api.decode_step(cfg, lshape, kernel_impl="ref"),
        params, state, tok, REST_CHECKED, "lmhybrid")
    state, lprof = profile_steps(torch, lstep, params, state, tok,
                                 LM_PROFILE, card, "lmhybrid")
    state = nosync_steps(torch, lstep, params, state, tok, REST_NOSYNC,
                         "lmhybrid")
    check(int(state.lengths[0]) == LONG_FROM + REST_STEPS + REST_CHECKED
          + LM_PROFILE + REST_NOSYNC,
          f"[lmhybrid] long_500k ended at {int(state.lengths[0])} tokens")
    q = torch.randn((1, cfg.n_heads, cfg.hd), generator=g, device=dev,
                    dtype=cfg.dtype)
    scores = scores_record(torch, ops, ref, q, planes[0].kmax,
                           planes[0].kmin, rate, card, "lmhybrid")
    del params, state, planes
    torch.cuda.empty_cache()
    return {"launches": launches, "long_launches": llaunch,
            "step_ms": step_ms, "first_ms": ms[0], "bound_ms": bnd[0],
            "vs_plain": vs_plain, "profile": prof, "attention": attn,
            "long_step_ms": l_ms, "long_bound_ms": lbnd[0],
            "long_vs_plain": lvs, "long_profile": lprof, "scores": scores}


def phase_lm_encdec(torch, ops, ref, configs, api, ep, card: str,
                    rate: float) -> dict:
    """seamless-m4t-medium at full width: decode (8 sequences, 2,048
    seeded tokens of context in each decoder layer's dense plane, a seeded
    encoder memory of 1,024 positions)."""
    dev = torch.device("cuda")
    cfg = rest_configs(configs)[3]
    shape = configs.ShapeConfig("serve", LM_SEQ, LM_BATCH, "decode")
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 16, device=dev)
    state = api.init_decode_state(cfg, shape, enc_len=ENC_LEN, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 17)
    fill_kv_prefix(torch, state, g, LM_PREFIX)
    for t in state.extra["k"] + state.extra["v"]:
        t.normal_(generator=g)
    torch.cuda.synchronize()
    enc = nbytes(params["enc_blocks"]) + params["enc_ln"].nbytes
    mem = nbytes(state.extra)
    lm_header("lmencdec", cfg, params,
              f"{cfg.dec_layers} decoder layers ({enc / 1e9:.2f} GB of "
              f"encoder weights, unused at decode); dense KV planes "
              f"{nbytes([[k.k_frames, k.v_frames] for k in state.kv]) / 1e9:.2f}"
              f" GB, cross memory {mem / 1e9:.2f} GB (enc_len {ENC_LEN}), "
              f"{LM_PREFIX} tokens of context x {LM_BATCH} sequences", t0)
    step = api.decode_step(cfg, shape)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    state, tok, ms, launches = counted_run(
        torch, ops, step, params, state, tok, REST_STEPS, "lmencdec",
        {"paged_attention": cfg.dec_layers})
    step_ms = statistics.median(ms[1:])
    w_bytes = nbytes(params) - params["embed"].nbytes - enc \
        + LM_BATCH * cfg.d_model * 2
    kv_bytes = cfg.dec_layers * 2 * LM_BATCH * (LM_PREFIX + REST_STEPS // 2) \
        * cfg.n_kv_heads * cfg.hd * 2
    bnd = bound(w_bytes + kv_bytes + mem, 2 * LM_BATCH * w_bytes / 2, rate,
                PEAK_BF16)
    log(f"[lmencdec] {REST_STEPS} greedy steps: {step_ms:.3f} ms per step "
        f"(median, synced; first {ms[0]:.3f} ms); step bound {bnd[0]:.3f} ms "
        f"by {bnd[1]} (decoder weights and lm_head {w_bytes / 1e9:.2f} GB, "
        f"K/V {kv_bytes / 1e9:.2f} GB, cross memory {mem / 1e9:.2f} GB) "
        f"[{card}]")
    state, tok, vs_plain = checked_steps(
        torch, ep, step, api.decode_step(cfg, shape, kernel_impl="ref"),
        params, state, tok, REST_CHECKED, "lmencdec")
    state, prof = profile_steps(torch, step, params, state, tok, LM_PROFILE,
                                card, "lmencdec")
    state = nosync_steps(torch, step, params, state, tok, REST_NOSYNC,
                         "lmencdec")
    kvc, _ = api.kv_plan(cfg, shape)
    q = torch.randn((LM_BATCH, cfg.n_heads, cfg.hd), generator=g,
                    device=dev, dtype=cfg.dtype)
    attn = attention_record(torch, ops, ref, state.kv[0], q, state.lengths,
                            kvc, rate, card, "lmencdec")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "first_ms": ms[0],
            "bound_ms": bnd[0], "vs_plain": vs_plain, "profile": prof,
            "attention": attn}


# --------------------------------------------------------------------------
# the training path: [trainattn], [trainblock], [trainfam], [train], [prefill]
# --------------------------------------------------------------------------

def train_modules():
    """The port's modules of the training path, as attributes of one
    object."""
    from repro_torch import configs, tree
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import api, attention, lm
    from repro_torch.optim import optimizers, schedules
    from repro_torch.runtime import orchestrator

    class T:
        pass
    for mod in (configs, tree, synthetic, train, api, attention, lm,
                optimizers, schedules, orchestrator):
        setattr(T, mod.__name__.rsplit(".", 1)[-1], mod)
    return T


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got = got.detach().to(want.device)
    top = float(want.detach().abs().max())
    return float((got - want.detach()).abs().max()) / max(top, 1e-30)


def phase_train_attn(torch, T, card: str) -> dict:
    """chunked_attention forward and backward at llama3-8b's head shapes
    against full_attention on the card (out, dq, dk, dv), causal and with a
    1,024 window; its fwd+bwd time beside scaled_dot_product_attention's
    (the same K/V heads repeated; for the record, not on the path)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)
    B, S, H, KVH, Dh = 1, ATTN_SEQ, LLAMA_HEADS, LLAMA_KV_HEADS, \
        LLAMA_HEAD_DIM
    q, k, v = (torch.randn(shape, generator=g, device=dev).requires_grad_()
               for shape in ((B, S, H, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh)))
    ct = torch.randn((B, S, H, Dh), generator=g, device=dev)
    qs = q.detach().transpose(1, 2).contiguous().requires_grad_()
    ks, vs = (x.detach().repeat_interleave(H // KVH, dim=2).transpose(1, 2)
              .contiguous().requires_grad_() for x in (k, v))
    cts = ct.transpose(1, 2).contiguous()
    pos = torch.arange(S, device=dev)
    flops = 12 * S * S * H * Dh * B      # QK^T and PV: forward + 2x backward
    bnd = flops / PEAK_F32 * 1e3
    out = {}
    for tag, window in (("causal", 0), ("window", ATTN_WINDOW)):
        def run(fn, **kw):
            o = fn(q, k, v, causal=True, window=window, **kw)
            return (o,) + torch.autograd.grad(o, (q, k, v), ct)

        def chunked():
            return run(T.attention.chunked_attention, chunk_q=ATTN_CHUNK,
                       chunk_k=ATTN_CHUNK)
        errs = [rel_err(a, b) for a, b in zip(
            chunked(), run(T.attention.full_attention))]
        for name, e in zip(("out", "dq", "dk", "dv"), errs):
            check(e <= TRAIN_TOL, f"[trainattn] {tag}: chunked_attention's "
                                  f"{name} off full_attention's by {e:.3g} "
                                  f"of the largest (tolerance {TRAIN_TOL})")
        torch.cuda.empty_cache()
        mask = None
        if window:
            mask = (pos[:, None] >= pos[None, :]) & (
                pos[None, :] > pos[:, None] - window)

        def lib():
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               is_causal=mask is None)
            return torch.autograd.grad(o, (qs, ks, vs), cts)
        ms = device_ms(torch, chunked, n=2, rounds=3)
        lib_ms = device_ms(torch, lib, n=2, rounds=3)
        log(f"[trainattn] {tag} (B {B}, S {S}, {H}/{KVH} heads, Dh {Dh}, "
            f"chunks of {ATTN_CHUNK}, f32): out/dq/dk/dv within "
            f"{max(errs):.3g} of the largest against full_attention "
            f"(tolerance {TRAIN_TOL}); fwd+bwd {ms:.3f} ms (library "
            f"scaled_dot_product_attention {lib_ms:.3f} ms, not on the path; "
            f"bound {bnd:.3f} ms by operations, every chunk pair at "
            f"{PEAK_F32 / 1e12:.0f} TFLOP/s) [{card}]")
        out[tag] = {"ms": ms, "library_ms": lib_ms, "bound_ms": bnd,
                    "max_rel_err": max(errs)}
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return out


def block_fwd_bwd(torch, T, cfg, gp, x, ct):
    """One block's output and the gradients of its parameters and input
    against the cotangent ``ct``."""
    flat = T.tree.leaves(gp)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in flat]
        xl = x.detach().requires_grad_()
        S = x.shape[1]
        pos = torch.arange(S, device=x.device).expand(x.shape[0], S)
        out, _ = T.lm._group_fwd(cfg, {}, 0, T.tree.unflatten(gp, live), xl,
                                 pos)
        grads = torch.autograd.grad(out, live + [xl], ct)
    return out.detach(), grads


def phase_train_block(torch, T, card: str) -> None:
    """One llama3-8b block at full width (attention through
    chunked_attention, RoPE, the SwiGLU MLP), forward and backward over 512
    positions on the card and on the CPU from the same parameters, input
    and cotangent: the output, every parameter gradient and the input's
    within 1e-4 of its largest |value|."""
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = T.configs.get_config("llama3-8b").scaled(n_layers=1,
                                                  dtype=torch.float32)
    gp = T.api.init_params(cfg, seed=SEED + 21, device=dev)["blocks"][0]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 22)
    x = torch.randn((1, BLOCK_SEQ, cfg.d_model), generator=g, device=dev)
    ct = torch.randn((1, BLOCK_SEQ, cfg.d_model), generator=g, device=dev)
    out_k, grads_k = block_fwd_bwd(torch, T, cfg, gp, x, ct)
    t0 = time.time()
    out_c, grads_c = block_fwd_bwd(torch, T, cfg, to_device(gp, cpu),
                                   x.cpu(), ct.cpu())
    cpu_s = time.time() - t0
    names = ["_".join(map(str, p)) for p, _ in T.tree.flatten_with_path(gp)]
    errs = {"out": rel_err(out_k, out_c)}
    errs.update({n: rel_err(a, b) for n, a, b in zip(
        names + ["x"], grads_k, grads_c)})
    for n, e in errs.items():
        check(e <= TRAIN_TOL, f"[trainblock] {n}: the card off the CPU by "
                              f"{e:.3g} of the largest (tolerance "
                              f"{TRAIN_TOL})")
    ms = device_ms(torch, lambda: block_fwd_bwd(torch, T, cfg, gp, x, ct),
                   n=2, rounds=3)
    n_w = sum(p.numel() for p in T.tree.leaves(gp))
    log(f"[trainblock] llama3-8b block ({n_w / 1e6:.1f}M parameters, f32), "
        f"{BLOCK_SEQ} positions: output, {len(names)} parameter gradients "
        f"and the input's within {max(errs.values()):.3g} of the largest on "
        f"the card against the CPU (tolerance {TRAIN_TOL}; worst "
        f"{max(errs, key=errs.get)}); fwd+bwd {ms:.3f} ms on the card, "
        f"{cpu_s:.1f}s on the CPU [{card}]")
    del gp, grads_k
    torch.cuda.empty_cache()


def jax_leaves(T, tree) -> list:
    """[(name, tensor)] of a params-shaped tree in JAX's stacked layout
    (per-layer lists stacked on leading axes), JAX's leaf order."""
    return [("_".join(map(str, path)), s.value()) for path, s in
            T.tree.flatten_with_path(T.optimizers.stacked(tree))]


def phase_train_fam(torch, T, card: str) -> None:
    """Every arch's smoke config (f32, remat as configured): the loss and
    every gradient through value_and_grad, then one make_train_step with
    the launcher's optimizer (Adafactor for kimi, AdamW otherwise) at a
    constant lr, on the card and on the CPU from the same parameters and
    batch (batch_for_step with the stub frontend inputs).  Leaves are
    compared in JAX's stacked layout (a leaf is all layers of one
    parameter), as the CPU tests compare them.  This reaches the dropping
    MoE with capacity under remat, mLSTM/sLSTM, Mamba2, the vision prefix
    and the encoder-decoder under autograd on CUDA."""
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    for arch in T.configs.ARCHS:
        cfg = T.configs.get_smoke(arch).scaled(dtype=torch.float32)
        pc = T.api.init_params(cfg, seed=SEED + 23, device=cpu)
        dcfg = T.synthetic.DataConfig(vocab=cfg.vocab, seq_len=FAM_SEQ,
                                      global_batch=FAM_BATCH, seed=SEED)
        nb = T.synthetic.batch_for_step(
            dcfg, 0, frontend=T.train.frontend_inputs(cfg, FAM_SEQ) or None)
        bc = {k: torch.from_numpy(v) for k, v in nb.items()}
        bk = to_device(bc, dev)
        vg = T.tree.value_and_grad(T.api.loss(cfg))
        lc, gc = vg(pc, bc)
        lk, gk = vg(to_device(pc, dev), bk)
        e_loss = abs(float(lk) - float(lc)) / abs(float(lc))
        check(e_loss <= FAM_LOSS_TOL, f"[trainfam] {arch}: loss {float(lk)} "
                                      f"on the card, {float(lc)} on the CPU")
        gk_s, gc_s = jax_leaves(T, gk), jax_leaves(T, gc)
        gerr = {n: rel_err(a, b) for (n, a), (_, b) in zip(gk_s, gc_s)}
        n_bad = max(gerr, key=gerr.get)
        check(gerr[n_bad] <= FAM_GRAD_TOL,
              f"[trainfam] {arch}: gradient {n_bad} off the CPU's by "
              f"{gerr[n_bad]:.3g} of the largest (tolerance {FAM_GRAD_TOL})")
        if cfg.moe_experts:
            check(all(float(b["moe"]["router"].abs().max()) > 0
                      for b in gk["blocks"]),
                  f"[trainfam] {arch}: a router gradient is zero")

        opt_name = "adafactor" if arch.startswith("kimi") else "adamw"
        opts = [T.optimizers.get_optimizer(
            opt_name, lr=T.schedules.constant_schedule(FAM_LR))
            for _ in range(2)]
        res = []
        for o, d, b in ((opts[0], cpu, bc), (opts[1], dev, bk)):
            p = to_device(pc, d) if d.type == "cuda" else T.tree.tree_map(
                torch.clone, pc)
            step = T.api.make_train_step(cfg, o)
            res.append(step(p, o.init(p), torch.zeros((), dtype=torch.int32,
                                                      device=d), b))
        (p_c, _, _, l_c, n_c), (p_k, _, _, l_k, n_k) = res
        e_l = abs(float(l_k) - float(l_c)) / abs(float(l_c))
        e_n = abs(float(n_k) - float(n_c)) / abs(float(n_c))
        check(e_l <= FAM_LOSS_TOL and e_n <= FAM_GRAD_TOL,
              f"[trainfam] {arch}: train step loss {float(l_k)} / "
              f"{float(l_c)}, gnorm {float(n_k)} / {float(n_c)} (card / CPU)")
        near, total, perr = 0, 0, 0.0
        for (_, a), (_, b), (_, ga), (_, gb) in zip(
                jax_leaves(T, p_k), jax_leaves(T, p_c), gk_s, gc_s):
            keep = torch.ones_like(b, dtype=torch.bool)
            if opt_name == "adamw":
                keep = (ga.cpu() - gb).abs() <= FAM_GRAD_AGREE * gb.abs()
                near += int((~keep).sum())
            total += b.numel()
            top = float(b.abs().max())
            d = (a.cpu() - b).abs()[keep]
            e = float(d.max()) / max(top, 1e-30) if d.numel() else 0.0
            perr = max(perr, e)
        check(perr <= TRAIN_TOL, f"[trainfam] {arch}: updated parameters "
                                 f"off the CPU's by {perr:.3g} of the "
                                 f"largest (tolerance {TRAIN_TOL})")
        log(f"[trainfam] {arch} ({cfg.family}, {opt_name}): loss "
            f"{float(lk):.5f}, rel err {e_loss:.2g}; gradients within "
            f"{gerr[n_bad]:.2g} ({n_bad}); step gnorm {float(n_k):.4f} rel "
            f"err {e_n:.2g}; updated parameters within {perr:.2g} ({near} of "
            f"{total} elements left out: their gradients part by more than "
            f"{FAM_GRAD_AGREE} of their own size)")
    torch.cuda.empty_cache()


def train_flops(cfg, params) -> tuple[float, dict]:
    """The step's operations: 6 N T for the parameters the step multiplies
    (every block matrix and lm_head; the embedding is an index), the
    remat's second forward of the blocks (2 N_blocks T), and the
    attention's score and value products in forward, recompute and
    backward over every chunk pair (16 S^2 H Dh a layer and sequence)."""
    blk = sum(params["blocks"][0]["attn"][w].numel()
              for w in ("wq", "wk", "wv", "wo")) + sum(
        params["blocks"][0]["mlp"][w].numel() for w in ("wi", "wg", "wo"))
    n_blocks = blk * cfg.n_layers
    n_head = params["lm_head"].numel()
    tok = TRAIN_BATCH * TRAIN_SEQ
    attn = 16 * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.hd * cfg.n_layers \
        * TRAIN_BATCH
    parts = {"6NT": 6 * (n_blocks + n_head) * tok,
             "remat": 2 * n_blocks * tok, "attention": attn}
    return float(sum(parts.values())), parts


def phase_train(torch, ops, T, card: str) -> dict:
    """llama3-8b at full width, 4 of its 32 layers, f32, through the
    launcher's pieces (launch.train.build, the orchestrator, async
    checkpoints): run A, 8 uninterrupted steps, timed one by one, and one
    more under the profiler; run B, the same 8 steps from the same state
    through the Orchestrator with a checkpoint every 4 and a failure at
    step 5 (restarts=1): the losses of steps 4-7 after the resume, and of
    steps 0-4 before it, equal to run A's."""
    import shutil
    dev = torch.device("cuda")
    cfg = T.configs.get_config("llama3-8b").scaled(n_layers=TRAIN_LAYERS,
                                                  dtype=torch.float32)
    opt = T.optimizers.get_optimizer(
        "adamw", lr=T.optimizers.cosine_schedule(3e-4, 20, TRAIN_STEPS))
    dcfg = T.synthetic.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=SEED)

    def batch_fn(step):
        return T.synthetic.batch_for_step(dcfg, step)
    step_fn = T.train.build(cfg, opt, TRAIN_ACCUM)

    def init_state():
        params = T.api.init_params(cfg, seed=SEED + 24, device=dev)
        return (params, opt.init(params),
                torch.zeros((), dtype=torch.int32, device=dev))

    # ---- run A: uninterrupted, timed ------------------------------------
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    state = init_state()
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in T.tree.leaves(state[0]))
    st_bytes = nbytes(list(state[:2]))
    flops, parts = train_flops(cfg, state[0])
    bnd = flops / PEAK_F32 * 1e3
    log(f"[train] llama3-8b {cfg.n_layers} of 32 layers at full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}), f32: {n_params / 1e9:.3f} B "
        f"parameters, params + AdamW moments {st_bytes / 1e9:.2f} GB; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} micro-batches, "
        f"remat {cfg.remat}; set up in {time.time() - t0:.1f}s")
    ops.reset_launch_counts()
    losses_a, ms = [], []
    for s in range(TRAIN_STEPS):
        batch = batch_fn(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses_a.append(float(m["loss"]))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses_a), f"[train] losses "
                                                   f"{losses_a}")
    check(int(state[2]) == TRAIN_STEPS, "[train] step counter")
    step_ms = statistics.median(ms[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    log(f"[train] run A: {TRAIN_STEPS} steps, {step_ms:.1f} ms per step "
        f"(median after the first; first {ms[0]:.1f} ms), {tok_s:,.0f} "
        f"tokens/s, peak memory allocated {peak / 1e9:.2f} GB; losses "
        f"{[round(x, 5) for x in losses_a]}; kernel launches {launches} "
        f"(the training path runs no hand-written kernel) [{card}]")
    box = [state]

    def one():
        box[0], _ = step_fn(box[0], batch_fn(TRAIN_STEPS))
    wall, busy, ops_n, rows = profiled(torch, one, 1)
    log(f"[train] profile of one step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% of the profiled wall, "
        f"{100 * busy * 1e3 / step_ms:.1f}% of the median step), "
        f"{ops_n:.0f} device operations [{card}]")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[train]   {dev_us / 1e3:9.1f} ms {count:7d}x  {key[:90]}")
    log(f"[train] step bound {bnd:.1f} ms by operations: {flops / 1e12:.2f} "
        f"TFLOP ({', '.join(f'{k} {v / 1e12:.2f}' for k, v in parts.items())}"
        f") at {PEAK_F32 / 1e12:.0f} TFLOP/s f32; the step takes "
        f"{step_ms / bnd:.2f}x the bound [{card}]")
    del state, box
    torch.cuda.empty_cache()

    # ---- run B: the orchestrator, a failure at step 5 --------------------
    torch.cuda.reset_peak_memory_stats()
    init = init_state()
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    losses_b = []

    def logged(st, batch):
        st, m = step_fn(st, batch)
        losses_b.append((int(st[2]) - 1, float(m["loss"])))
        return st, m
    O = T.orchestrator
    orch = O.Orchestrator(
        O.OrchestratorConfig(ckpt_dir=str(ckdir),
                             ckpt_every=TRAIN_CKPT_EVERY, keep=1),
        logged, batch_fn, injector=O.FailureInjector([TRAIN_FAIL_AT]))
    t1 = time.time()
    state = orch.run(init, TRAIN_STEPS)
    wall_b = time.time() - t1
    peak_b = torch.cuda.max_memory_allocated()
    m = orch.metrics
    steps = [s for s, _ in losses_b]
    want = list(range(TRAIN_FAIL_AT)) + list(
        range(TRAIN_CKPT_EVERY, TRAIN_STEPS))
    check(m["restarts"] == 1 and steps == want,
          f"[train] run B: restarts={m['restarts']}, steps {steps}")
    check(int(state[2]) == TRAIN_STEPS, "[train] run B's step counter")
    rel = [abs(lb - losses_a[s]) / abs(losses_a[s]) for s, lb in losses_b]
    check(max(rel) <= RESUME_RTOL,
          f"[train] run B's losses off run A's by {max(rel):.3g} (relative; "
          f"tolerance {RESUME_RTOL}): {losses_b} against {losses_a}")
    log(f"[train] run B: done: steps={m['steps']} restarts={m['restarts']} "
        f"stragglers={m['stragglers']} final_loss={losses_b[-1][1]:.4f}; "
        f"{wall_b:.1f}s with {sum(m['step_times']):.1f}s in steps (the "
        f"rest: 3 checkpoints of {st_bytes / 1e9:.1f} GB, one restore); "
        f"peak memory allocated {peak_b / 1e9:.2f} GB (the caller's initial "
        f"state beside the trained copy, as in JAX); "
        f"the losses of steps {TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} after "
        f"the resume and of steps 0-{TRAIN_FAIL_AT - 1} before it within "
        f"{max(rel):.3g} of run A's (relative; tolerance {RESUME_RTOL}) "
        f"[{card}]")
    del state, init
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_per_s": tok_s, "peak_bytes": peak,
            "bound_ms": bnd, "flops": flops, "busy_share": busy / step_ms
            * 1e3, "launches": launches}


def phase_prefill(torch, ops, T, card: str) -> dict:
    """make_prefill_step's last-token logits for llama3-8b at full width, 4
    layers, f32, 2 sequences of 64 seeded tokens, against the 64th logits
    of decode_step run token by token through the dense KV plane (its
    paged_attention kernel, 4 launches a token): rtol and atol 3e-3."""
    dev = torch.device("cuda")
    cfg = T.configs.get_config("llama3-8b").scaled(n_layers=TRAIN_LAYERS,
                                                  dtype=torch.float32)
    params = T.api.init_params(cfg, seed=SEED + 25, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 26)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_TOKENS),
                           generator=g, device=dev, dtype=torch.int32)
    prefill = T.api.make_prefill_step(cfg)
    prefill(params, {"tokens": tokens})
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre_launches = ops.launch_counts()
    shape = T.configs.ShapeConfig("prefill", PREFILL_TOKENS, PREFILL_BATCH,
                                  "decode")
    state = T.api.init_decode_state(cfg, shape, device=dev)
    step = T.api.decode_step(cfg, shape)
    ops.reset_launch_counts()
    for t in range(PREFILL_TOKENS):
        state, logits = step(params, state, tokens[:, t])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = cfg.n_layers * PREFILL_TOKENS
    check(launches["paged_attention"] == want,
          f"[prefill] paged_attention launched {launches['paged_attention']} "
          f"times decoding {PREFILL_TOKENS} tokens through {cfg.n_layers} "
          f"layers ({want} wanted)")
    check(sum(pre_launches.values()) == 0,
          f"[prefill] the prefill step launched {pre_launches}")
    diff = (got - logits).abs()
    ok = bool((diff <= PREFILL_TOL + PREFILL_TOL * logits.abs()).all())
    err = rel_err(got, logits)
    check(ok, f"[prefill] prefill logits off the decoded ones by "
              f"{float(diff.max()):.3g} (rtol and atol {PREFILL_TOL})")
    log(f"[prefill] llama3-8b {cfg.n_layers} layers f32, {PREFILL_BATCH} x "
        f"{PREFILL_TOKENS} tokens: the prefill step's last-token logits "
        f"within {float(diff.max()):.3g} of decode_step's 64th (rtol and "
        f"atol {PREFILL_TOL}; {err:.3g} of the largest); prefill "
        f"{pre_ms:.1f} ms; decode launched paged_attention {want} times "
        f"({cfg.n_layers} a token, f32: CUDA cores) [{card}]")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "max_rel_err": err, "prefill_ms": pre_ms}


def phase_mesh_layout(torch, m, T, card: str) -> dict:
    """llama3-8b at full width, 2 layers, f32, batch 2 x 2,048: one plain
    train step, then one on parameters, AdamW state and batch laid out on
    a (1, 1) mesh over an NCCL group of one rank from their logical specs
    (``launch.mesh``, ``shard`` active), from one host copy, one model on
    the card at a time: loss, gnorm and every updated parameter within
    1e-5 of the largest; each side's second step timed.  Then
    ``ckpt.restore(mesh=, spec_tree=param_pspecs)`` of those parameters:
    DTensors with the resolved placements, equal bit for bit.  Returns the
    kernel launches of the mesh steps."""
    import contextlib
    import shutil
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import ckpt
    M, api, tree = m.mesh, T.api, T.tree
    dev = torch.device("cuda")
    cfg = T.configs.get_config("llama3-8b").scaled(n_layers=LAYOUT_LAYERS,
                                                  dtype=torch.float32)
    shape = T.configs.ShapeConfig("meshlayout", LAYOUT_SEQ, LAYOUT_BATCH,
                                  "train")
    opt = T.optimizers.get_optimizer("adamw")
    fn = api.make_train_step(cfg, opt)
    specs = api.batch_specs(cfg, shape)
    batch_np = T.synthetic.batch_for_step(T.synthetic.DataConfig(
        vocab=cfg.vocab, seq_len=LAYOUT_SEQ, global_batch=LAYOUT_BATCH,
        seed=SEED), 0)
    t0 = time.time()
    host = tree.tree_map(lambda x: x.cpu(), api.init_params(
        cfg, seed=SEED + 25, device=dev))
    torch.cuda.empty_cache()
    n_params = sum(x.numel() for x in tree.leaves(host))

    def steps(mesh, on_first):
        """Two steps from the host copy, ``on_first(loss, gnorm, params)``
        after the first; returns the ms of each."""
        params = tree.tree_map(lambda x: x.to(dev, copy=True), host)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch_np.items()}
        step = torch.full((), LAYOUT_STEP, dtype=torch.int32, device=dev)
        ctx = contextlib.ExitStack()
        if mesh is not None:
            params = M.distribute_tree(params, mesh, api.param_pspecs(cfg))
            batch = {k: M.distribute(v, mesh, specs[k][1])
                     for k, v in batch.items()}
            step = M.distribute(step, mesh, None)
            ctx.enter_context(M.use_mesh(mesh))
            ctx.enter_context(implicit_replication())
        ms = []
        with ctx:
            state = opt.init(params)
            for i in range(2):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                params, state, step, loss, gnorm = fn(params, state, step,
                                                      batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                if i == 0:
                    on_first(loss, gnorm, params)
        return ms

    plain = {}
    ms_plain = steps(None, lambda loss, gnorm, params: plain.update(
        loss=loss, gnorm=gnorm, params=tree.tree_map(
            lambda x: x.to("cpu", copy=True), params)))
    torch.cuda.empty_cache()
    init = f"tcp://localhost:{free_port()}"
    M.init_far(0, 1, init)
    try:
        mesh = M.make_host_mesh(1, 1, device_type="cuda")
        seen = {}

        def compare(loss, gnorm, params):
            worst = 0.0
            for got, want in [(loss, plain["loss"]), (gnorm, plain["gnorm"])
                              ] + list(zip(tree.leaves(params),
                                           tree.leaves(plain["params"]))):
                worst = max(worst, rel_err(got.full_tensor(), want.to(dev)))
            seen.update(worst=worst, placements=sorted(
                {str(tuple(p.placements)) for p in tree.leaves(params)}))
        m.ops.reset_launch_counts()
        ms_mesh = steps(mesh, compare)
        launches = m.ops.launch_counts()
        torch.cuda.empty_cache()
        check(seen["worst"] <= LAYOUT_TOL,
              f"[meshlayout] the step on the mesh is {seen['worst']:.3g} of "
              f"the largest off the plain step's")
        log(f"[meshlayout] llama3-8b {LAYOUT_LAYERS} of 32 layers at full "
            f"width, f32, {n_params / 1e9:.3f} B parameters, batch "
            f"{LAYOUT_BATCH} x {LAYOUT_SEQ}, AdamW from step {LAYOUT_STEP}: "
            f"the step laid out on a (data 1, model 1) mesh of an NCCL group "
            f"of one rank (placements {seen['placements']}) == the plain "
            f"step: loss {float(plain['loss']):.6f}, gnorm "
            f"{float(plain['gnorm']):.4f}, loss, gnorm and all "
            f"{len(tree.leaves(plain['params']))} updated parameters within "
            f"{seen['worst']:.3g} of the largest (tolerance {LAYOUT_TOL}) "
            f"[{card}]")
        log(f"[meshlayout] ms per step: plain {ms_plain[1]:.1f} (first "
            f"{ms_plain[0]:.1f}), on the mesh {ms_mesh[1]:.1f} (first "
            f"{ms_mesh[0]:.1f}): DTensor's host cost "
            f"{ms_mesh[1] - ms_plain[1]:.1f} ms a step; kernel launches "
            f"{launches} [{card}]")
        # the parameters restored onto the mesh from a checkpoint
        ckdir = ROOT / "build" / "meshlayout_ckpt"
        shutil.rmtree(ckdir, ignore_errors=True)
        t1 = time.time()
        ckpt.save(str(ckdir), 1, host)
        got, _ = ckpt.restore(str(ckdir), 1, host, mesh=mesh,
                              spec_tree=api.param_pspecs(cfg))
        same = True
        for (path, g), w in zip(tree.flatten_with_path(got),
                                tree.leaves(host)):
            spec = api.param_pspecs(cfg)
            for k in path:
                spec = spec[k]
            same &= list(g.placements) == M.placements(mesh, spec)
            same &= torch.equal(g.full_tensor(), w.to(dev))
        check(bool(same), "[meshlayout] the restored parameters differ from "
                          "the saved ones or their placements")
        del got
        shutil.rmtree(ckdir, ignore_errors=True)
        log(f"[meshlayout] ckpt.restore(mesh=, spec_tree=param_pspecs) of "
            f"those parameters: DTensors with each spec's placements, equal "
            f"bit for bit ({time.time() - t1:.1f}s with the save) "
            f"({time.time() - t0:.1f}s in all) [{card}]")
    finally:
        m.dist.destroy_process_group()
        torch.cuda.empty_cache()
    return {"ms_plain": ms_plain[1], "ms_mesh": ms_mesh[1],
            "launches": launches}


def meshdec_config(configs):
    """[meshdecode]: llama3-8b at full width, MESHDEC_LAYERS of its 32."""
    return configs.get_config("llama3-8b").scaled(n_layers=MESHDEC_LAYERS)


def field_err(torch, x, y) -> tuple[bool, float]:
    """(x and y finite at the same places, the largest |x - y| there over
    the largest finite |y|), one slice of the first dimension at a time
    (a long_500k slab is 1 GB a field)."""
    if torch.equal(x, y):
        return True, 0.0
    same, err, top = True, 0.0, 0.0
    for a, b in zip(x, y):
        a, b = a.float(), b.float()
        fin = torch.isfinite(b)
        same &= bool(torch.equal(fin, torch.isfinite(a)))
        zero = torch.zeros((), device=b.device)
        err = max(err, float(torch.where(fin, a - b, zero).abs().max()))
        top = max(top, float(torch.where(fin, b, zero).abs().max()))
    return same, err / max(top, 1e-30)


def plane_fields_match(torch, api, cfg, shape, got, want, shards: int):
    """Every KV plane of two serve states of one cell, in their logical
    views: (every int and bool field equal, the worst float field's error
    over its largest |value|, the number of fields compared)."""
    kvc, _ = api.kv_plan(cfg, shape, shards)
    same, worst, n = True, 0.0, 0
    for a, b in zip(kv_planes(got), kv_planes(want)):
        for k in a._fields:
            x, y = a.view(kvc, k), b.view(kvc, k)
            n += 1
            if x.is_floating_point():
                fin, err = field_err(torch, x, y)
                same &= fin
                worst = max(worst, err)
            else:
                same &= bool(torch.equal(x, y))
    return same, worst, n


def logged_run(torch, ops, step, params, state, tok, steps: int, tag: str,
               want: dict, as_input=lambda t: t):
    """``steps`` greedy steps with the launch counts set to 0 just before
    and read just after, as counted_run counts them (each kernel of
    ``want`` exactly that many times a step, every other never); returns
    (state, each step's logits whole, ms a step, launches)."""
    from torch.distributed.tensor import DTensor
    ops.reset_launch_counts()
    logits_all, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logits = step(params, state, as_input(tok))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        # a replayed step's logits are its graph's buffer, which the next
        # replay overwrites
        logits_all.append(logits.clone())
        tok = logits.argmax(dim=-1).to(torch.int32)
    launches = ops.launch_counts()
    for k in ("gather_rows", "compact_pages", "cat_decay", "page_scores",
              "paged_attention", "cat_update"):
        check(launches[k] == want.get(k, 0) * steps,
              f"[{tag}] {k} launched {launches[k]} times in {steps} steps, "
              f"{want.get(k, 0)} a step wanted: {launches}")
    check(launches["paged_attention_mma"] == launches["paged_attention"],
          f"[{tag}] {launches['paged_attention_mma']} of "
          f"{launches['paged_attention']} paged_attention launches on the "
          f"tensor cores")
    check(all(bool(torch.isfinite(x).all()) for x in logits_all),
          f"[{tag}] non-finite logits")
    return state, logits_all, ms, launches


def expert_fields_match(torch, got, want):
    """The expert planes of two serve states in their logical views, as
    plane_fields_match compares KV planes."""
    same, worst, n = True, 0.0, 0
    for a, b in zip(got.extra, want.extra):
        for k in a._fields:
            x, y = a.view(k), b.view(k)
            n += 1
            if x.is_floating_point():
                fin, err = field_err(torch, x, y)
                same &= fin
                worst = max(worst, err)
            else:
                same &= bool(torch.equal(x, y))
    return same, worst, n


def unit_mesh_tree(M, tree, mesh, spec_tree):
    """``tree`` laid out by its specs on a mesh of one rank, each DTensor's
    local tensor the leaf itself (``launch.mesh.distribute`` copies a
    split leaf; kimi-k2's 33.8 GB slab has no room for a copy)."""
    from torch.distributed.tensor import DTensor
    check(mesh.size() == 1, "unit_mesh_tree: a mesh of more than one rank")
    real = M.distribute
    M.distribute = lambda x, mesh_, spec: DTensor.from_local(
        x, mesh_, M.placements(mesh_, spec))
    try:
        return M.distribute_tree(tree, mesh, spec_tree)
    finally:
        M.distribute = real


def mesh_decode_cell(torch, m, api, cfg, mesh, params, dparams, name,
                     shape, prefix, want, g, card: str) -> dict:
    """One [meshdecode] cell: MESHDEC_STEPS greedy steps on the plain path
    and on the mesh from one seeded state, checked as phase_mesh_decode
    says; returns its times, launches and logit error."""
    from torch.distributed.tensor.experimental import implicit_replication
    M = m.mesh
    dev = torch.device("cuda")
    kvc, mode = api.kv_plan(cfg, shape, 1)
    state = api.init_decode_state(cfg, shape, shards=1, device=dev)
    if mode == "sparse":
        for p in kv_planes(state):
            fill_sparse_slab(torch, kvc, p, g)
        state.lengths.fill_(prefix)
    else:
        fill_kv_prefix(torch, state, g, prefix)
    tok = torch.randint(0, cfg.vocab, (shape.global_batch,), generator=g,
                        device=dev, dtype=torch.int32)
    mstate = api.serve_state_on_mesh(cfg, shape, state.clone(), mesh, 1)
    torch.cuda.synchronize()
    step = api.decode_step(cfg, shape, shards=1)
    tag = f"meshdecode {name}"
    state, want_logits, ms_plain, l_plain = logged_run(
        torch, m.ops, step, params, state, tok, MESHDEC_STEPS, tag, want)
    tok_spec = api.batch_specs(cfg, shape)["tokens"][1]
    with M.use_mesh(mesh), implicit_replication():
        mstate, got_logits, ms_mesh, l_mesh = logged_run(
            torch, m.ops, step, dparams, mstate, tok, MESHDEC_STEPS, tag,
            want, lambda t: M.distribute(t, mesh, tok_spec))
    worst = max(rel_err(a, b) for a, b in zip(got_logits, want_logits))
    check(worst <= LAYOUT_TOL,
          f"[{tag}] the mesh step's logits are {worst:.3g} of the largest "
          f"off the plain step's")
    whole = api.serve_state_whole(cfg, shape, mstate, mesh, 1)
    same, fworst, n = plane_fields_match(torch, api, cfg, shape, whole,
                                         state, 1)
    e_same, e_worst, e_n = expert_fields_match(torch, whole, state)
    same, fworst, n = same and e_same, max(fworst, e_worst), n + e_n
    check(same, f"[{tag}] an int or bool plane field differs")
    check(fworst <= LAYOUT_TOL, f"[{tag}] a float plane field is "
                                f"{fworst:.3g} off")
    check(bool(torch.equal(whole.lengths, state.lengths)),
          f"[{tag}] lengths differ")
    check(l_mesh == l_plain, f"[{tag}] launches on the mesh {l_mesh} "
                             f"against {l_plain} plain")
    pm, mm = statistics.median(ms_plain[1:]), statistics.median(ms_mesh[1:])
    from repro_torch.configs import get_config
    full = get_config(cfg.name).n_layers
    planes = f"{mode} plane{'s' if mode == 'dense' else ''}" + (
        f" and {len(whole.extra)} expert plane"
        f"{'s' if len(whole.extra) > 1 else ''}" if e_n else "")
    log(f"[{tag}] {cfg.name} {cfg.n_layers} of {full} layers at full "
        f"width, bf16, {planes} ({shape.global_batch} x {shape.seq_len} "
        f"tokens, from {prefix}): {MESHDEC_STEPS} greedy steps on a (data "
        f"1, model 1) mesh of an NCCL group of one rank == the plain step: "
        f"logits within {worst:.3g} of the largest (tolerance "
        f"{LAYOUT_TOL}), {n} plane fields (ints and bools bit for bit, "
        f"floats within {fworst:.3g}); ms a step plain {pm:.3f} (first "
        f"{ms_plain[0]:.1f}), on the mesh {mm:.3f} (first "
        f"{ms_mesh[0]:.1f}); launches a step "
        f"{ {k: v / MESHDEC_STEPS for k, v in l_mesh.items() if v} } both "
        f"ways [{card}]")
    del state, mstate, whole
    torch.cuda.empty_cache()
    return {"ms_plain": pm, "ms_mesh": mm, "launches": l_mesh,
            "logit_err": worst}


def phase_mesh_decode(torch, m, configs, api, card: str) -> dict:
    """The serve step on a model mesh on the card: parameters laid out on
    a (1, 1) ("data", "model") mesh over an NCCL group of one rank, bf16,
    seeded weights, and the serve state by ``api.serve_state_on_mesh``.
    llama3-8b at full width, MESHDEC_LAYERS layers: dense decode (as [lm]:
    8 sequences, 2,048 seeded tokens of context) and long_500k (shards =
    dp = 1, each layer's sparse plane filled as [kvsparse]); kimi-k2 at
    full width, 1 of 61 layers, through the expert plane (as [lmexpert];
    its parameters shared with the plain step, ``unit_mesh_tree``).
    MESHDEC_STEPS greedy steps on the mesh and on the plain path from the
    same state: logits within LAYOUT_TOL of the largest each step; every
    int and bool field of every KV and expert plane bit for bit, floats
    within LAYOUT_TOL, after ``serve_state_whole``; the mesh step's kernel
    launches equal the plain step's (paged_attention on the dense steps;
    page_scores and gather_rows on the sparse one; gather_rows, the
    expert fetch, on kimi-k2's); ms a step both ways.  Returns the mesh
    steps' launches."""
    M = m.mesh
    dev = torch.device("cuda")
    cfg = meshdec_config(configs)
    t0 = time.time()
    params = api.init_params(cfg, seed=SEED + 27, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 28)
    M.init_far(0, 1, f"tcp://localhost:{free_port()}")
    out = {}
    try:
        mesh = M.make_host_mesh(1, 1, device_type="cuda")
        dparams = M.distribute_tree(params, mesh, api.param_pspecs(cfg))
        cells = (("dense", configs.ShapeConfig("serve", LM_SEQ, LM_BATCH,
                                               "decode"), LM_PREFIX,
                  {"paged_attention": cfg.n_layers}),
                 ("long_500k", configs.ShapeConfig("long", LONG_SEQ, 1,
                                                   "decode_long"), LONG_FROM,
                  {"page_scores": cfg.n_layers,
                   "gather_rows": 2 * cfg.n_layers}))
        for name, shape, prefix, want in cells:
            out[name] = mesh_decode_cell(torch, m, api, cfg, mesh, params,
                                         dparams, name, shape, prefix, want,
                                         g, card)
        params = dparams = None
        torch.cuda.empty_cache()
        kcfg = lm_configs(configs)[1]
        params = api.init_params(kcfg, seed=SEED + 29, device=dev)
        dparams = unit_mesh_tree(M, params, mesh, api.param_pspecs(kcfg))
        out["kimi-k2"] = mesh_decode_cell(
            torch, m, api, kcfg, mesh, params, dparams, "kimi-k2",
            configs.ShapeConfig("serve", LM_SEQ, LM_BATCH, "decode"),
            LM_PREFIX, {"paged_attention": kcfg.n_layers,
                        "gather_rows": 3 * kcfg.n_layers}, g, card)
    finally:
        m.dist.destroy_process_group()
        params = dparams = None
        torch.cuda.empty_cache()
    launches = {k: sum(c["launches"][k] for c in out.values())
                for k in out["dense"]["launches"]}
    log(f"[meshdecode] took {time.time() - t0:.1f}s [{card}]")
    return {"cells": out, "launches": launches}


def phase_dryrun(torch, card: str) -> None:
    """The port's dry-run (``launch.dryrun.run_cell``) on fake ``cuda``
    meshes at full width, 2 of 32 layers, for DRYRUN_CELLS: the argument
    bytes a device (llama3-8b's against the arithmetic: each 2-D parameter
    split over every chip, the norms whole), the FLOPs a device beside the
    analytic model's, the collectives by kind, MemTracker's peak and the
    trace's seconds; gradient sync in the train cells; in the long_500k
    cell the sparse combine's three all-gathers over dp a layer; in
    kimi-k2's cell no all-gather of the hot store and its products'
    partial sums all-reduced over dp, two a layer."""
    from repro_torch import configs
    from repro_torch.analysis import comm
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import api
    from repro_torch.tree import leaves
    real, real_summary = mesh.all_gather, comm.collective_summary
    gathers, records = [], []

    def spy(x, m, logical="dp"):
        gathers.append(logical)
        return real(x, m, logical)

    def summary(recs):
        records[:] = recs
        return real_summary(recs)
    for arch, sname, kind in DRYRUN_CELLS:
        gathers.clear()
        mesh.all_gather, comm.collective_summary = spy, summary
        try:
            rec = dryrun.run_cell(arch, sname, kind,
                                  layers_override=DRYRUN_LAYERS,
                                  device="cuda")
        finally:
            mesh.all_gather, comm.collective_summary = real, real_summary
        check(rec["status"] == "ok", f"[dryrun] {arch} {sname} {kind}: "
                                     f"{rec.get('error')}\n"
                                     f"{rec.get('traceback', '')}")
        chips = 512 if kind == "multi" else 256
        cfg, shape = dryrun.cell_config(arch, sname, DRYRUN_LAYERS)
        ab = rec["arg_bytes_per_device"]
        if arch == "llama3-8b":
            pbytes = sum(x.numel() * x.element_size() / (chips if x.dim() == 2
                                                         else 1)
                         for x in leaves(api.param_shapes(cfg)))
            check(ab["params"]["device"] == pbytes,
                  f"[dryrun] parameter bytes {ab['params']['device']} "
                  f"against {pbytes}")
            arith = f" (params {pbytes:,.0f} == the arithmetic)"
        else:
            arith = f" (params {ab['params']['device']:,.0f})"
        flops = rec["cost_analysis"]["flops"]
        model = rec["analytic"]["flops_per_chip"]
        coll = rec["collectives"]
        by_kind = {k: (v["count"], v["wire_bytes_corrected"])
                   for k, v in coll.items()
                   if isinstance(v, dict) and v["count"]}
        if shape.kind == "train":
            check(coll["all-reduce"]["count"] + coll["reduce-scatter"][
                "count"] > 0, "[dryrun] no gradient sync in a train cell")
        combine = ""
        if shape.kind == "decode_long":
            check(gathers == ["dp"] * 3 * DRYRUN_LAYERS
                  and coll["all-gather"]["count"] >= len(gathers),
                  f"[dryrun] the sparse combine all-gathered {gathers}, "
                  f"{coll['all-gather']['count']} all-gathers in all")
            combine = (f"; the sparse combine's {len(gathers)} all-gathers "
                       f"over dp (acc, m, l a layer)")
        else:
            check(gathers == [], f"[dryrun] all-gathers {gathers} outside "
                                 "a sparse cell")
        if api._uses_expert_plane(cfg):
            epc = api._expert_cfg(cfg)
            hot = (epc.hot_slots * cfg.d_model * cfg.d_ff
                   * epc.dtype.itemsize)
            dp = rec["mesh_shape"]["data"] * rec["mesh_shape"].get("pod", 1)
            C = -(-shape.global_batch * cfg.moe_topk * 2 // epc.hot_slots)
            partial = epc.hot_slots * max(8, C) * cfg.d_ff * 4
            held = [r for r in records if r["kind"] == "all-gather"
                    and r["out_bytes"] == hot]
            sums = [r for r in records if r["kind"] == "all-reduce"
                    and r["group"] == dp and r["out_bytes"] == partial]
            check(not held and len(sums) == 2 * DRYRUN_LAYERS,
                  f"[dryrun] {arch}: {len(held)} all-gathers of the hot "
                  f"store, {len(sums)} all-reduces of the expert products' "
                  f"partial sums ({2 * DRYRUN_LAYERS} wanted)")
            combine = (f"; no all-gather of the hot store ({hot:,} B a "
                       f"tensor), the products' partial sums all-reduced "
                       f"over dp {len(sums)} times ({partial:,} B each)")
        mem = rec["memory"]
        log(f"[dryrun] {arch} {sname} on {kind} {rec['mesh_shape']}, "
            f"{DRYRUN_LAYERS} of {configs.get_config(arch).n_layers} layers: "
            f"argument bytes a device {ab['total']['device']:,.0f}{arith}, "
            f"host_tier "
            f"{ab['total']['host_tier']:,.0f}; FLOPs a device {flops:.4g} "
            f"traced, {model:.4g} analytic (ratio {flops / model:.3f}); "
            f"collectives {by_kind} (count, wire bytes){combine}; MemTracker "
            f"peak {mem['Total']:,} B (Parameter {mem['Parameter']:,}, Other "
            f"{mem['Other']:,}, Activation {mem['Activation']:,}, Temp "
            f"{mem['Temp']:,}); traced in {rec['trace_s']}s "
            f"({rec['total_s']}s with the fake group) [{card}]")


def port_modules():
    """The port's modules the phases use, as attributes of one object."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.core import (baselines, batch, faults, kvplane, plane,
                                  shardplane, state)
    from repro_torch.data import kvworkload
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, serve
    from repro_torch.serving import engine

    class M:
        pass
    for mod in (convert, baselines, batch, faults, kvplane, plane,
                shardplane, state, kvworkload, ops, mesh, serve, engine):
        setattr(M, mod.__name__.rsplit(".", 1)[-1], mod)
    M.dist = dist
    M.np = np
    return M


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import configs, convert
    from repro_torch.core import expertplane, kvplane, plane
    from repro_torch.kernels import _build, gather_objects, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import api, mlp

    M = port_modules()
    batch, engine, kvworkload = M.batch, M.engine, M.kvworkload

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
    kernels[0]["shapes"].update(phase_row_copy(torch, ops, ref, gather_objects,
                                               eng.state, card, rate))
    phase_oracles(torch, M)

    # ---- serve at full size ----------------------------------------------
    wl = np.stack(list(kvworkload.zipf_churn(
        OBJECTS, BATCH, SERVE_TICKS + NOSYNC_TICKS, seed=SEED)))
    ids_all = torch.from_numpy(wl).to(dev)
    mism = torch.zeros((), dtype=torch.int64, device=dev)
    plain_s = eng.state.clone()
    served = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.latency = engine.LatencyTracker()
    tick_ms = []
    t0 = time.time()
    for t in range(SERVE_TICKS):
        ts = time.time()
        rows = eng.submit(ids_all[t])
        mism += (rows != data_t[ids_all[t]]).any(dim=1).sum()
        served.append(rows)
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
        f"({ {k: v / SERVE_TICKS for k, v in launches.items()} } per tick; "
        f"a graph replay counts the launches its captured call counted: "
        f"{eng.replay_counts})")
    check(n_mism == 0, f"{n_mism} served rows differ from the data")
    check_replayed(torch, M, ops, eng, plain_s, ids_all, served, launches,
                   "serve")
    for k in ("page_ins", "obj_ins", "evac_pages", "epochs"):
        check(stats[k] > 0, f"serve: {k} is 0")
    for k in ("gather_rows", "compact_pages", "cat_decay"):
        check(launches[k] > 0, f"serve: kernel {k} was never launched")
    log(f"[serve] 0 of {SERVE_TICKS * BATCH} served rows differ from the data")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    by_path = {"serve": launches}
    ops_per_tick = {"hybrid": profile_ticks(torch, eng, ids_all, 0, 16, card,
                                            "serve")}
    if "--profile" in sys.argv:
        phase_profile(torch, plane, eng, card)

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

    # ---- the baseline planes, the reclaim loop, the robust engine ----------
    del eng, s, data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for pl in ("paging", "object"):
        by_path[pl], ops_per_tick[pl] = phase_baseline(torch, M, ops, pl,
                                                       data_t, ids_all, card)
    by_path["reclaim"] = phase_reclaim(torch, M, ops, card)
    by_path["robust"] = phase_robust(torch, M, ops, data_t, card)
    by_path["shard"], ops_per_tick["shard"], shard_rps = phase_shard(
        torch, M, ops, data_t, ids_all, card)
    by_path["shardrobust"] = phase_shard_robust(torch, M, ops, data_t, card)
    by_path["shardmesh"] = phase_shard_mesh(torch, M, data_t, ids_all, card)
    per_tick = {pl: by_path[pl if pl != "hybrid" else "serve"]["gather_rows"]
                / SERVE_TICKS for pl in ("hybrid", "paging", "object")}
    log(f"[planes] device ops per tick {ops_per_tick}; gather_rows launches "
        f"per tick {per_tick} ({SERVE_TICKS} ticks of mcd_cl at {OBJECTS} "
        f"objects, batch {BATCH}) [{card}]")

    # ---- the KV serve plane at llama3-8b's widths --------------------------
    del data_t, ids_all, wl
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

    # ---- the model decode path at full width --------------------------------
    lm = phase_lm(torch, ops, ref, configs, api, expertplane, card, rate)
    lmx = phase_lm_expert(torch, ops, ref, configs, api, expertplane, convert,
                          card, rate)
    log("[rest] depth cut: mixtral-8x7b decodes 16 of its 32 layers (32 "
        "layers of bf16 weights take ~93 GB)")
    log(f"[rest] context: decode from {LM_PREFIX} seeded tokens in a "
        f"{LM_SEQ}-token plane; mixtral's window from {WINDOW_FROM}; "
        f"zamba2's long_500k from {LONG_FROM} of {LONG_SEQ}; xlstm from a "
        f"fresh state")
    moe = phase_lm_moe(torch, ops, ref, configs, api, expertplane, mlp, card,
                       rate)
    ssm = phase_lm_ssm(torch, ops, configs, api, card, rate)
    hyb = phase_lm_hybrid(torch, ops, ref, configs, api, expertplane, card,
                          rate)
    encd = phase_lm_encdec(torch, ops, ref, configs, api, expertplane, card,
                           rate)
    T = train_modules()
    t_train = time.time()
    tattn = phase_train_attn(torch, T, card)
    phase_train_block(torch, T, card)
    phase_train_fam(torch, T, card)
    trn = phase_train(torch, ops, T, card)
    pre = phase_prefill(torch, ops, T, card)
    t_mesh = time.time()
    lay = phase_mesh_layout(torch, M, T, card)
    t_dec = time.time()
    mdec = phase_mesh_decode(torch, M, configs, api, card)
    t_dry = time.time()
    phase_dryrun(torch, card)
    log(f"[meshlayout] [meshdecode] [dryrun] took {time.time() - t_mesh:.1f}s "
        f"([meshdecode] {t_dry - t_dec:.1f}s, [dryrun] "
        f"{time.time() - t_dry:.1f}s) [{card}]")
    log(f"[train] summary: llama3-8b {TRAIN_LAYERS} layers f32, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: {trn['step_ms']:.1f} ms per step, "
        f"{trn['tokens_per_s']:,.0f} tokens/s, peak "
        f"{trn['peak_bytes'] / 1e9:.2f} GB, device busy "
        f"{100 * trn['busy_share']:.1f}% of the step, bound "
        f"{trn['bound_ms']:.1f} ms ({trn['flops'] / 1e12:.2f} TFLOP at "
        f"f32); chunked attention "
        f"fwd+bwd {tattn['causal']['ms']:.2f} ms causal (SDPA "
        f"{tattn['causal']['library_ms']:.2f} ms); the training phases took "
        f"{time.time() - t_train:.1f}s [{card}]")
    rest = {"lmmoe": moe["launches"], "lmmoe_window": moe["window_launches"],
            "lmssm": ssm["launches"], "lmhybrid": hyb["launches"],
            "lmhybrid_long": hyb["long_launches"],
            "lmencdec": encd["launches"], "train": trn["launches"],
            "prefill": pre["launches"], "meshlayout": lay["launches"],
            "meshdecode": mdec["launches"]}
    for k in kernels:
        if k["name"] in ("page_scores", "paged_attention", "cat_update"):
            # cat_update is on no runtime path, in the JAX package either
            k["launches"] = kv_launches[k["name"]]
            k["launches_per_step"] = kv_launches[k["name"]] / KV_STEPS
        else:
            k["launches_per_step"] = k["launches"] / SERVE_TICKS
            k["launches_by_path"] = {p: c[k["name"]]
                                     for p, c in by_path.items()}
    next(k for k in kernels if k["name"] == "gather_rows")[
        "launches_per_tick_by_plane"] = per_tick
    pa = next(k for k in kernels if k["name"] == "paged_attention")
    pa["dense_launches_per_step"] = (dense_launches["paged_attention"]
                                     / DENSE_STEPS)
    pa["launches_mma"] = kv_launches["paged_attention_mma"]
    for k in kernels:
        k.setdefault("launches_by_path", {}).update(
            lm=lm["launches"][k["name"]], lmexpert=lmx["launches"][k["name"]],
            shardmesh=by_path["shardmesh"][k["name"]],
            **{p: c[k["name"]] for p, c in rest.items()})
    gr = next(k for k in kernels if k["name"] == "gather_rows")
    gr["expert_fetch"] = dict(lmx["gather"], launches_per_step=lmx[
        "launches"]["gather_rows"] / LM_STEPS)
    pa["lm"] = dict(lm["attention"], launches_per_step=lm["launches"][
        "paged_attention"] / LM_STEPS)
    pa["dh112"] = dict(lmx["attention"], launches_per_step=lmx["launches"][
        "paged_attention"] / LM_STEPS)
    # G = 1, Dh 64: zamba2's shared attention (8 x 32 pairs, one block a
    # pair) and seamless's self-attention (8 x 16 pairs, pages split)
    pa["g1_dh64_zamba2"] = dict(hyb["attention"], launches_per_step=hyb[
        "launches"]["paged_attention"] / REST_STEPS)
    pa["g1_dh64_seamless"] = dict(encd["attention"], launches_per_step=encd[
        "launches"]["paged_attention"] / REST_STEPS)
    ps = next(k for k in kernels if k["name"] == "page_scores")
    ps["zamba2_long"] = dict(hyb["scores"], launches_per_step=hyb[
        "long_launches"]["page_scores"] / REST_STEPS)
    gr["zamba2_long_launches_per_step"] = hyb["long_launches"][
        "gather_rows"] / REST_STEPS
    log(f"[rest] summary: mixtral-8x7b 16 layers {moe['step_ms']:.3f} ms per "
        f"step (bound {moe['bound_ms']:.3f} ms), window "
        f"{moe['window_step_ms']:.3f} ms; xlstm-350m batch {SSM_BATCH} "
        f"{ssm['step_ms']:.3f} ms (bound {ssm['bound_ms']:.3f} ms); "
        f"zamba2-1.2b {hyb['step_ms']:.3f} ms (bound {hyb['bound_ms']:.3f} "
        f"ms), long_500k {hyb['long_step_ms']:.3f} ms (bound "
        f"{hyb['long_bound_ms']:.3f} ms); seamless-m4t-medium "
        f"{encd['step_ms']:.3f} ms (bound {encd['bound_ms']:.3f} ms) "
        f"[{card}]")
    log(f"[lm] summary: llama3-8b {lm['step_ms']:.3f} ms per step (bound "
        f"{lm['bound_ms']:.3f} ms), kimi-k2 one layer {lmx['step_ms']:.3f} "
        f"ms per step (bound {lmx['bound_ms']:.3f} ms) [{card}]")

    log(f"[done] {time.time() - t_start:.1f}s [{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    sys.exit(main())
