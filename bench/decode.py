"""The model-decode runner: set-up, the measured window, and the check of
what the window decoded, for any decode configuration.  What belongs to
one model family and KV-plane mode is its kit's.

The configuration names its kit (``kit``; without the key, ``lm_dense``):
the module ``bench/<kit>.py``, found by file name, so a configuration of
another family, batch or plane mode arrives as new files.  The model is
the configuration's ``model`` block, taken as the port's ``ArchConfig``
fields by name; the traffic's ``batch``, ``capacity_tokens`` and
``shape_kind`` (``decode_long``, the default, or ``decode``) make the
shape, and ``models.api.kv_plan`` picks the plane.  Set-up takes the kit's
seeded weights (checked against ``api.param_shapes``), makes the program's
state (``api.init_decode_state``), has the kit write each sequence's
context into it, and runs ``warm_steps`` greedy steps through
``models.api.decode_step`` (the first, the start, recorded for the check).
The window is a closed loop of greedy steps: each step's tokens
``[batch]`` are the argmax of the step before, taken on the card, and the
host never waits for the device inside it.  Once ``seconds`` have passed,
``CHECKED`` more steps are made with every row's logits and what the
kit's recorder takes; the window closes when the card has finished them.
After it, the kit keeps what its check reads of the program's state, the
state is freed, and the kit judges the recorded steps.

With ``trace`` a segment of ``SEGMENT_STEPS`` steps, begun after
``SEGMENT_AT`` of the window, runs under ``torch.profiler`` with spans
around the kit's step parts; host-clock readings come only from the steps
before it.

A kit module gives:

* ``FAMILIES`` and ``MODES``: the model families and plane modes it takes;
* ``LIMITS``: each number its check compares, with its limit;
* ``STEP_PARTS``: ``(module, attribute, span)`` for the traced segment;
* ``SMOKE``: its CPU size (``at_smoke_size``);
* ``Kit(run)``, whose methods the runner calls in this order:
  ``params()`` the weights in the program's tree; ``fill(state)`` the
  context written into the planes, returning the position of the first
  fed token; ``first_tokens()`` ``[batch]``; ``after_warm(state)`` a dict
  of what the planes hold after warm-up; ``describe()`` the set-up line's
  words on the context and the planes, that dict among them;
  ``recording(rec)`` a context in which a checked step's records go into
  ``rec``; ``keep(state, last)`` what the check
  reads of the state, before it is freed; ``judge(steps, kept, fed)``
  the readings (``program``, ``per_step`` and, with ``run.control``,
  ``control``); ``counts()`` ``flops_per_step``, ``bytes_per_step`` and
  whatever else its readers read; ``describe_checked()`` the check's line;
* optionally ``CONTROL`` (its judge reads the control too) and ``FAULTS``
  (``name: (module, attribute, wrap)``), which ``bench.lm_control`` runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import math
import time
from pathlib import Path

import torch
from repro_torch import configs
from repro_torch.models import api

from . import host
from . import trace as trace_lib

SEGMENT_STEPS = 4
SEGMENT_AT = 0.6
CHECKED = 2                 # the window's last steps, judged after it
DEFAULT_KIT = "lm_dense"
SHAPE_KINDS = ("decode_long", "decode")
BENCH = Path(__file__).resolve().parent

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


def kit_of(cfg: dict):
    """The kit module a configuration names: ``bench/<kit>.py``."""
    name = cfg.get("kit", DEFAULT_KIT)
    if not (isinstance(name, str) and name.isidentifier()
            and (BENCH / f"{name}.py").is_file()):
        raise ValueError(f"configuration {cfg.get('name')!r} names the kit "
                         f"{name!r}: there is no bench/{name}.py")
    return importlib.import_module(f"bench.{name}")


def at_smoke_size(cfg: dict, mix: dict) -> tuple:
    """The configuration and traffic at their kit's CPU size, and what to
    set there: ``(cfg, mix, patches)``, each patch ``(object, attribute,
    value)``: the program's constants and the kit's ``LIMITS``.  The kit's
    ``SMOKE`` gives ``config`` (top-level blocks, a dict merged into the
    block), ``traffic`` (keys set), ``program`` (patches) and ``limits``."""
    kit = kit_of(cfg)
    s = kit.SMOKE
    cfg = dict(cfg)
    for k, v in s["config"].items():
        cfg[k] = dict(cfg.get(k, {}), **v) if isinstance(v, dict) else v
    return (cfg, dict(mix, **s["traffic"]),
            list(s["program"]) + [(kit, "LIMITS", s["limits"])])


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


def _same_tree(a, b, path: str) -> None:
    """Raise where tree ``a`` differs from ``b`` in keys, lengths, shapes
    or dtypes."""
    if isinstance(b, dict):
        if set(a) != set(b):
            raise ValueError(f"{path}: keys {sorted(a)} against the "
                             f"program's {sorted(b)}")
        for k in b:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        if len(a) != len(b):
            raise ValueError(f"{path}: {len(a)} layers, program {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"{path}: {tuple(a.shape)} {a.dtype} against the "
                         f"program's {tuple(b.shape)} {b.dtype}")


class Run:
    """One run of a decode cell: everything the metrics and the check
    read."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device, log=print):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.log = log
        self.kit_mod = kit_of(cfg)
        self.model = arch_config(cfg["model"])
        if self.model.family not in self.kit_mod.FAMILIES:
            raise ValueError(f"the kit {self.kit_mod.__name__} takes the "
                             f"families {self.kit_mod.FAMILIES}, not "
                             f"{self.model.family!r}")
        kind = mix.get("shape_kind", "decode_long")
        if mix["loop"] != "closed" or kind not in SHAPE_KINDS:
            raise ValueError(f"the decode runner takes a closed loop of "
                             f"shape {SHAPE_KINDS}, not {mix['loop']!r} "
                             f"{kind!r}")
        self.batch = int(mix["batch"])
        self.shape = configs.ShapeConfig(kind, int(mix["capacity_tokens"]),
                                         self.batch, kind)
        self.kvc, self.mode = api.kv_plan(self.model, self.shape)
        if self.mode not in self.kit_mod.MODES:
            raise ValueError(f"the kit {self.kit_mod.__name__} takes the "
                             f"plane modes {self.kit_mod.MODES}; the program "
                             f"plans {self.mode!r} for this shape")
        self.host_s = []            # host s of each step before the segment
        self.fed = []               # the tokens fed to each step, in order
        self.checked = []           # the recorded steps
        self.segment = None
        self.steps = 0
        self.control = False        # judge the control too (bench.lm_control)
        self.kit = self.kit_mod.Kit(self)

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        dev = self.device
        t0 = time.time()
        self.params = self.kit.params()
        _same_tree(self.params, api.param_shapes(self.model), "params")
        self.weights_s = time.time() - t0
        self.state = api.init_decode_state(self.model, self.shape,
                                           device=dev)
        t0 = time.time()
        self.pos = self.kit.fill(self.state)
        self.fill_s = time.time() - t0
        self.step_fn = api.decode_step(self.model, self.shape)
        self.tok = self.kit.first_tokens()
        t0 = time.time()
        self._step(record=True, start=True)
        for _ in range(int(self.mix["warm_steps"]) - 1):
            self._step()
        self.after_warm = self.kit.after_warm(self.state)
        self.warm_s = time.time() - t0
        # what set-up made stays alive for the run: keep the collector's
        # full passes from walking it inside the window
        gc.collect()
        gc.freeze()

    # -- a step -------------------------------------------------------------

    def _step(self, record: bool = False, start: bool = False) -> None:
        """One greedy step; the next tokens are the argmax, on the card."""
        self.fed.append(self.tok)
        if record:
            rec = {}
            with self.kit.recording(rec):
                self.state, logits = self.step_fn(self.params, self.state,
                                                  self.tok)
            self.checked.append(dict(rec, t=self.pos, tok=self.tok,
                                     logits=logits, start=start))
        else:
            self.state, logits = self.step_fn(self.params, self.state,
                                              self.tok)
        self.tok = logits[:, :self.model.vocab].argmax(dim=-1)
        self.pos += 1

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
            for mod, name, label in self.kit_mod.STEP_PARTS:
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
        """Read the peak and what the kit's check reads of the program's
        state, free the state, then have the kit judge the recorded
        steps."""
        dev = self.device
        _sync(dev)
        gc.unfreeze()
        self.memory_peak = (torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0)
        steps = self.checked
        kept = self.kit.keep(self.state, steps[-1]["t"])
        del self.state, self.params, self.step_fn
        self.checked = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.time()
        self.readings = self.kit.judge(steps, kept, self.fed)
        self.reference_s = time.time() - t0
        got = self.readings["program"]
        lim = self.kit_mod.LIMITS
        self.checks = {k: (got[k], lim[k]) for k in lim}
        self.failed = sum(any(s[k] > lim[k] for k in lim)
                          for s in self.readings["per_step"])
        return self.checks

    @property
    def attempted(self) -> int:
        return self.steps

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())

    def end_to_end(self) -> dict:
        """The end-to-end readings of this run (host clock)."""
        return {"decode_tokens_per_s": self.batch * self.steps / self.window_s}

    # -- what the run logs ----------------------------------------------------

    def log_setup(self, name: str, setup_s: float, build_s: float,
                  kind: str) -> None:
        n_w = sum(t.numel() for t in _leaves(self.params))
        self.log(f"[bench] {name} seed {self.seed}: {self.model.n_layers} "
                 f"layers, {n_w / 1e9:.3f} B weights made in "
                 f"{self.weights_s:.2f} s; {self.kit.describe()} filled in "
                 f"{self.fill_s:.2f} s; {self.mix['warm_steps']} warm steps "
                 f"in {self.warm_s:.2f} s; kernel build {build_s:.1f} s; "
                 f"set-up {setup_s:.3f} s on {kind}")

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
                 f"of {self.batch} from position {self.pos0}{q}")
        self.log(f"[bench] host events in the window: {self.host_events}")

    def log_checked(self) -> None:
        self.log(f"[bench] {len(self.readings['per_step'])} steps judged "
                 f"against the reference in {self.reference_s:.1f} s "
                 f"{self.kit.describe_checked()}; correct: {self.correct}")


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
    """What the per-layer readers of a decode cell read: the host clock,
    the traced segment, the card's peaks and the kit's counts."""
    seg = None
    if run.segment is not None:
        seg = {"steps": run.segment["steps"], "trace": tr,
               "before": run.segment["before"]}
    counts = run.kit.counts()
    for k in ("flops_per_step", "bytes_per_step"):
        if k not in counts:
            raise ValueError(f"the kit {run.kit_mod.__name__} counts no {k}")
    return {"host_s": run.host_s, "segment": seg, **counts,
            "flops_per_s": peaks.get("bf16_dense_flops_per_s"),
            "hbm_bytes_per_s": peaks.get("hbm_bytes_per_s")}
