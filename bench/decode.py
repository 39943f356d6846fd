"""The model-decode cell: set-up, the measured window, and the check of
what the window decoded.

The model is the configuration file's ``model`` block, taken as the
port's ``ArchConfig`` fields by name; the traffic's ``capacity_tokens``
makes a ``decode_long`` shape, so ``models.api.kv_plan`` puts each layer's
KV cache on the sparse plane (its page size, top-K, local frames and
fetch budget must be the ones the configuration's ``plane`` block
states).  Set-up makes the weights and each layer's context from the seed
on the device (``bench/lm_inputs.py``), writes the context into the
planes' far tier with its page summaries, as a prefill would leave it,
and runs ``warm_steps`` greedy steps through ``models.api.decode_step``
(the first, the start, recorded for the check).  The window is a closed
loop of greedy steps: each step's token is the argmax of the step before,
taken on the card, and the host never waits for the device inside it.
Once ``seconds`` have passed, ``CHECKED`` more steps are made with their
selections, attended rows and logits recorded; the window closes when the
card has finished them.  After it, the program's state is freed and
``bench/lm_reference.py`` judges the recorded steps.

With ``trace`` a segment of ``SEGMENT_STEPS`` steps, begun after
``SEGMENT_AT`` of the window, runs under ``torch.profiler`` with spans
around the step's parts; host-clock readings come only from the steps
before it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import math
import time

import torch
from repro_torch import configs
from repro_torch.core import kvplane
from repro_torch.models import api
from repro_torch.models import mlp as mlp_lib

from . import host, lm_counts, lm_inputs, lm_reference
from . import trace as trace_lib

SEGMENT_STEPS = 4
SEGMENT_AT = 0.6
CHECKED = 2                 # the window's last steps, judged after it

clock = time.perf_counter


def arch_config(model: dict) -> configs.ArchConfig:
    """The port's ``ArchConfig`` from a ``model`` block (its fields by
    name; ``dtype`` by its torch name).  Keys that are not fields (such as
    ``rms_norm_eps``, which the port fixes) are left to the reference."""
    fields = {f.name for f in dataclasses.fields(configs.ArchConfig)}
    kw = {k: v for k, v in model.items() if k in fields}
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    return configs.ArchConfig(**kw)


def host_mark() -> dict:
    """``bench/host.py``'s readings with the collector's passes, to
    difference over the window."""
    return dict(host.usage(), steal_s=host.steal_s(),
                gc_passes=sum(g["collections"] for g in gc.get_stats()))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


# the step's parts, spanned in the traced segment
STEP_PARTS = ((api, "_attn_qkv", "bench.qkv"),
              (kvplane, "append_sharded", "bench.append"),
              (kvplane, "_select", "bench.select"),
              (kvplane, "fetch_pages", "bench.fetch"),
              (kvplane, "_attend_pages_partial", "bench.attend"),
              (kvplane, "_profile", "bench.profile"),
              (mlp_lib, "mlp", "bench.mlp"),
              (api, "_logits", "bench.logits"))


class Run:
    """One run of a decode cell: everything the metrics and the check
    read."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device, log=print):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.log = log
        self.model = arch_config(cfg["model"])
        if self.model.family != "dense":
            raise ValueError(f"the decode runner takes dense decoders, not "
                             f"{self.model.family!r}")
        self.dims = lm_inputs.dims(cfg["model"])
        if mix["loop"] != "closed" or int(mix["batch"]) != 1:
            raise ValueError("the sparse plane decodes one sequence: a "
                             "closed loop at batch 1")
        self.shape = configs.ShapeConfig("long", int(mix["capacity_tokens"]),
                                         1, "decode_long")
        self.kvc, mode = api.kv_plan(self.model, self.shape)
        plane = cfg["plane"]
        have = {"page_tokens": self.kvc.page_tokens,
                "topk_pages": self.kvc.sparse_topk,
                "local_frames": self.kvc.num_frames,
                "fetch_budget": self.kvc.fetch_budget,
                "car_threshold": self.kvc.car_threshold}
        if mode != "sparse" or any(plane[k] != v for k, v in have.items()):
            raise ValueError(f"the program's plane is {mode} {have}, the "
                             f"configuration states sparse {plane}")
        self.context = int(mix["context_tokens"])
        if self.context % self.kvc.page_tokens or \
                self.context + 1 >= self.shape.seq_len:
            raise ValueError("the context fills whole pages, short of the "
                             "plane's capacity")
        self.host_s = []            # host s of each step before the segment
        self.fed = []               # the token fed to each step, in order
        self.checked = []           # the recorded steps
        self.segment = None
        self.steps = 0
        self.control = False        # judge the control too (bench.lm_control)

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        m, dev = self.dims, self.device
        t0 = time.time()
        self.params = self._params()
        self.weights_s = time.time() - t0
        self.state = api.init_decode_state(self.model, self.shape,
                                           device=dev)
        t0 = time.time()
        self._fill()
        self.fill_s = time.time() - t0
        self.step_fn = api.decode_step(self.model, self.shape)
        self.tok = lm_inputs.first_token(m, self.seed, dev)
        self.pos = self.context
        t0 = time.time()
        self._step(record=True, start=True)
        for _ in range(int(self.mix["warm_steps"]) - 1):
            self._step()
        F = self.kvc.num_frames
        self.held = min(int((s.frame_page[:F] >= 0).sum())
                        for s in self.planes())
        self.warm_s = time.time() - t0
        # what set-up made stays alive for the run: keep the collector's
        # full passes from walking it inside the window
        gc.collect()
        gc.freeze()

    def _params(self) -> dict:
        """The benchmark's weights in the program's tree, checked against
        the program's own shapes and dtypes."""
        m, dev = self.dims, self.device
        blocks = []
        for layer in range(m["L"]):
            w = lm_inputs.layer_weights(m, self.seed, layer, dev)
            blocks.append({"ln1": w["ln1"], "ln2": w["ln2"],
                           "attn": {k: w[k] for k in ("wq", "wk", "wv",
                                                      "wo")},
                           "mlp": {"wi": w["mlp_wi"], "wg": w["mlp_wg"],
                                   "wo": w["mlp_wo"]}})
        p = dict(lm_inputs.embed_and_head(m, self.seed, dev), blocks=blocks)
        want = api.param_shapes(self.model)

        def same(a, b, path):
            if isinstance(b, dict):
                if set(a) != set(b):
                    raise ValueError(f"{path}: keys {sorted(a)} against the "
                                     f"program's {sorted(b)}")
                for k in b:
                    same(a[k], b[k], f"{path}.{k}")
            elif isinstance(b, list):
                if len(a) != len(b):
                    raise ValueError(f"{path}: {len(a)} layers, program "
                                     f"{len(b)}")
                for i, (x, y) in enumerate(zip(a, b)):
                    same(x, y, f"{path}[{i}]")
            elif a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"{path}: {tuple(a.shape)} {a.dtype} "
                                 f"against the program's "
                                 f"{tuple(b.shape)} {b.dtype}")
        same(p, want, "params")
        return p

    def planes(self) -> list:
        return [kv[0] for kv in self.state.kv]

    def _fill(self) -> None:
        """Each layer's context into its plane's far tier, with the page
        summaries (``write_page_to_slab``'s, for every page at once)."""
        P = self.kvc.page_tokens
        n = self.context // P
        for layer, s in enumerate(self.planes()):
            k, v = lm_inputs.context_layer(self.dims, self.mix["context"], n,
                                           P, self.seed, layer, self.device)
            s.k_slab[:, :n].copy_(k)
            s.v_slab[:, :n].copy_(v)
            s.kmax[:, :n].copy_(k.amax(dim=2).float())
            s.kmin[:, :n].copy_(k.amin(dim=2).float())
            del k, v
        self.state.lengths.fill_(self.context)

    # -- a step -------------------------------------------------------------

    def _step(self, record: bool = False, start: bool = False) -> None:
        """One greedy step; the next token is the argmax, on the card."""
        self.fed.append(self.tok)
        if record:
            layers = []
            with self._recording(layers):
                self.state, logits = self.step_fn(self.params, self.state,
                                                  self.tok)
            self.checked.append({"t": self.pos, "tok": self.tok,
                                 "logits": logits[0], "layers": layers,
                                 "start": start})
        else:
            self.state, logits = self.step_fn(self.params, self.state,
                                              self.tok)
        self.tok = logits[:, :self.dims["vocab"]].argmax(dim=-1)
        self.pos += 1

    @contextlib.contextmanager
    def _recording(self, layers: list):
        """Each layer's selection and the query it was scored with; the
        plane's page table, PSF, hints, card bits and page rows before the
        fetch, the table, PSF and hints after it; the rows attended with
        the frames' contents; the card bits after the profiling: appended
        to ``layers`` as the step runs."""
        def select(orig):
            def inner(cfg, s, q, n_valid, newest):
                top = orig(cfg, s, q, n_valid, newest)
                layers.append({"tops": top[0], "q": q[0].float().clone()})
                return top
            return inner

        def fetch(orig):
            def inner(cfg, s, tops, fills, **kw):
                rec = layers[-1]
                rec.update(pt=s.page_table.clone(), psf=s.psf.clone(),
                           hint=s.hot_hint.clone(), cat=s.cat.clone(),
                           prow=s.page_rows.clone())
                out = orig(cfg, s, tops, fills, **kw)
                rec.update(pt_after=s.page_table.clone(),
                           psf_after=s.psf.clone(),
                           hint_after=s.hot_hint.clone())
                return out
            return inner

        def profile(orig):
            def inner(cfg, s, *a):
                orig(cfg, s, *a)
                layers[-1]["cat_after"] = s.cat.clone()
            return inner

        def attend(orig):
            def inner(q, kf, vf, table, rows):
                at = table[0].clamp_min(0).long()
                layers[-1].update(table=table[0], rows=rows[0],
                                  kf=kf[:, at], vf=vf[:, at])
                return orig(q, kf, vf, table, rows)
            return inner
        with patched(kvplane, "_select", select), \
                patched(kvplane, "fetch_pages", fetch), \
                patched(kvplane, "_attend_pages_partial", attend), \
                patched(kvplane, "_profile", profile):
            yield

    # -- the window -----------------------------------------------------------

    def window(self) -> None:
        dev = self.device
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.pos0 = self.pos
        mark = host_mark()
        seg_at = SEGMENT_AT * self.seconds if self.trace else math.inf
        last = self.shape.seq_len - 1 - CHECKED - SEGMENT_STEPS
        t0 = self._t0 = clock()
        while True:
            now = clock() - t0
            if now >= self.seconds:
                break
            if self.pos >= last:
                self.log(f"[bench] the window reached the plane's capacity "
                         f"at {now:.3f} s (capacity_tokens is too low)")
                break
            if now >= seg_at and self.segment is None:
                self._segment()
                continue
            ts = clock()
            self._step()
            self.steps += 1
            if self.segment is None:
                self.host_s.append(clock() - ts)
        for _ in range(CHECKED):
            self._step(record=True)
            self.steps += 1
        _sync(dev)
        self.window_s = clock() - t0
        end = host_mark()
        self.host_events = {k: round(end[k] - mark[k], 3) for k in mark}
        if self.trace and self.segment is None:
            self._segment()

    def _segment(self) -> None:
        """``SEGMENT_STEPS`` steps under the profiler, each step's parts in
        spans."""
        dev = self.device
        before = (clock() - self._t0, len(self.host_s))
        _sync(dev)
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(trace_lib.profiled(dev))
            for mod, name, label in STEP_PARTS:
                stack.enter_context(patched(
                    mod, name, functools.partial(trace_lib.wrap, label=label)))
            with trace_lib.span("bench.window"):
                for _ in range(SEGMENT_STEPS):
                    with trace_lib.span("bench.step"):
                        self._step()
                    self.steps += 1
                _sync(dev)
        self.segment = {"steps": SEGMENT_STEPS, "prof": prof,
                        "before": before}

    # -- after the window -----------------------------------------------------

    def check(self) -> dict:
        """Read the peak and the appended rows, free the program's state,
        then judge the recorded steps against the reference."""
        dev, P = self.device, self.kvc.page_tokens
        _sync(dev)
        gc.unfreeze()
        self.memory_peak = (torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0)
        last = self.checked[-1]["t"]
        a, b = self.context // P, last // P + 1
        n = last + 1 - self.context
        app_k, app_v = [], []
        for s in self.planes():
            KVH, hd = s.k_slab.shape[0], s.k_slab.shape[-1]
            app_k.append(s.k_slab[:, a:b].reshape(KVH, -1, hd)[:, :n].clone())
            app_v.append(s.v_slab[:, a:b].reshape(KVH, -1, hd)[:, :n].clone())
        fed = torch.cat(self.fed[:n]).to(torch.int64)
        steps = [{"t": c["t"], "token": int(c["tok"]), "logits": c["logits"],
                  "layers": c["layers"], "start": c["start"]}
                 for c in self.checked]
        del self.state, self.params, self.step_fn
        self.checked = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.time()
        ref = lm_reference.Reference(self.cfg["model"], self.cfg["plane"],
                                     self.mix["context"], self.seed,
                                     self.context, dev, control=self.control)
        self.readings = ref.run(steps, app_k, app_v, fed)
        self.reference_s = time.time() - t0
        got = self.readings["program"]
        lim = lm_reference.LIMITS
        self.checks = {k: (got[k], lim[k]) for k in lim}
        self.failed = sum(any(s[k] > lim[k] for k in lim)
                          for s in self.readings["per_step"])
        window_steps = range(len(steps) - CHECKED, len(steps))
        self.attended_rows = sum(self.readings["attended_rows"][i]
                                 for i in window_steps) / CHECKED
        self.fetched_pages = sum(self.readings["fetched_pages"][i]
                                 for i in window_steps) / CHECKED
        return self.checks

    @property
    def attempted(self) -> int:
        return self.steps

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())

    def end_to_end(self) -> dict:
        """The end-to-end readings of this run (host clock)."""
        return {"decode_tokens_per_s":
                int(self.mix["batch"]) * self.steps / self.window_s}

    # -- what the run logs ----------------------------------------------------

    def log_setup(self, name: str, setup_s: float, build_s: float,
                  kind: str) -> None:
        m = self.dims
        n_w = sum(t.numel() for t in _leaves(self.params))
        self.log(f"[bench] {name} seed {self.seed}: {m['L']} layers, "
                 f"{n_w / 1e9:.3f} B weights made in {self.weights_s:.2f} s; "
                 f"{self.context} tokens of context in each of "
                 f"{len(self.planes())} sparse planes ({self.kvc.num_pages} "
                 f"pages, {self.kvc.num_frames} frames, top-"
                 f"{self.kvc.sparse_topk}, fetch budget "
                 f"{self.kvc.fetch_budget}) filled in {self.fill_s:.2f} s; "
                 f"{self.mix['warm_steps']} warm steps in {self.warm_s:.2f} "
                 f"s (after them the emptiest layer holds {self.held} of its "
                 f"{self.kvc.num_frames} frames); kernel build {build_s:.1f} "
                 f"s; set-up {setup_s:.3f} s on {kind}")

    def log_window(self) -> None:
        t = sorted(self.host_s)
        q = ""
        if len(t) >= 4:
            q = (f"; host ms a step: quartiles "
                 + " ".join(f"{t[int(f * (len(t) - 1))] * 1e3:.2f}"
                            for f in (0.25, 0.5, 0.75))
                 + f", max {t[-1] * 1e3:.2f} ({len(t)} steps before any "
                   f"traced segment)")
        self.log(f"[bench] window {self.window_s:.3f} s, {self.steps} steps "
                 f"from position {self.pos0}{q}")
        self.log(f"[bench] host events in the window: {self.host_events}")

    def log_checked(self) -> None:
        r = self.readings
        steps = [{k: round(v, 6) for k, v in s.items()} for s in r["per_step"]]
        self.log(f"[bench] {len(r['per_step'])} steps judged against the "
                 f"reference in {self.reference_s:.1f} s (the start and the "
                 f"window's last {CHECKED}; layer 0's appended rows of "
                 f"{r['layer0_rows']} steps); per step "
                 f"{steps}; rows attended "
                 f"{r['attended_rows']} and pages fetched "
                 f"{r['fetched_pages']} a step over the layers; correct: "
                 f"{self.correct}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def record(run: Run, tr, peaks: dict) -> dict:
    """What the per-layer readers of a decode cell read."""
    seg = None
    if run.segment is not None:
        seg = {"steps": run.segment["steps"], "trace": tr,
               "before": run.segment["before"]}
    m, kvc = run.cfg["model"], run.kvc
    counts = lm_counts.StepCounts(
        attended_rows=run.attended_rows, fetched_pages=run.fetched_pages,
        summary_pages=kvc.num_pages, page_tokens=kvc.page_tokens,
        batch=int(run.mix["batch"]))
    return {"host_s": run.host_s, "segment": seg,
            "flops_per_step": lm_counts.step_flops(m, counts),
            "bytes_per_step": lm_counts.step_bytes(m, counts),
            "flops_per_s": peaks.get("bf16_dense_flops_per_s"),
            "hbm_bytes_per_s": peaks.get("hbm_bytes_per_s")}
