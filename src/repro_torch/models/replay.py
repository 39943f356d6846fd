"""A decode step replayed from one captured CUDA graph (``api.decode_step``
of the decoder-only families, on a card).

An eager decode step dispatches every small device operation of every
layer from Python: at a long context through the sparse KV plane some
250 a layer, so the host, not the card, sets the step's rate.  ``Replayed``
captures the whole step once, as one graph, and replays it: one launch a
token, plus the copies of the tokens and the lengths into the graph's
input buffers.

When a step replays is decided only from what the call can observe
(``may_replay``): a CUDA device, no model mesh current, and every function
the step reaches still the one its module bound at import
(``as_imported``).  A function replaced since (a test's monkeypatch, a
recorder of checked steps, a planted fault) would be bypassed by a replay
of the graph captured before it, so such a call runs eagerly and no graph
is captured while it is; a wrapper that declares its original through
``__wrapped__`` (``functools.wraps``, which ``inspect.unwrap`` follows)
counts as that original.
"""
from __future__ import annotations

import inspect
import operator
import weakref

import torch
from torch.distributed.tensor import DTensor

from ..core import trace
from ..kernels import ops
from ..launch import mesh as mesh_lib

SPAN = "engine.decode.replay"
# replays the host may have launched that the card has not finished: a
# replay waits for the one launched this many calls before it
IN_FLIGHT = 2


def originals(modules) -> tuple:
    """``(module, name, function)`` for every function bound at the top
    level of each of ``modules`` now, unwrapped (``inspect.unwrap``)."""
    return tuple((m, name, inspect.unwrap(f)) for m in modules
                 for name, f in vars(m).items() if inspect.isfunction(f))


def as_imported(functions) -> bool:
    """Whether each ``(module, name, function)`` of ``functions``
    (``originals``) is still bound there: the function itself, or a
    wrapper that declares it through ``__wrapped__``."""
    for m, name, f in functions:
        cur = getattr(m, name, None)
        if cur is f:
            continue
        try:
            if inspect.unwrap(cur) is not f:
                return False
        except ValueError:              # a cycle of ``__wrapped__``
            return False
    return True


def may_replay(device, functions) -> bool:
    """Whether a step on ``device`` may replay from a graph: a CUDA device,
    no model mesh current (a mesh step runs DTensor dispatch and
    collectives), and ``functions`` as imported (``as_imported``)."""
    return (torch.device(device).type == "cuda"
            and mesh_lib.current_mesh() is None and as_imported(functions))


def _leaves(tree, planes: list, tensors: list) -> bool:
    """Sort the leaves of ``tree`` (dicts, lists and tuples of them) into
    ``planes``, plane states (objects whose ``_fields`` are tensors that
    the planes' functions may rebind, as ``s.step = s.step + 1``), and
    ``tensors``; False where a leaf is neither."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, dict):
        return all(_leaves(v, planes, tensors) for v in tree.values())
    elif isinstance(tree, (list, tuple)):
        return all(_leaves(v, planes, tensors) for v in tree)
    elif hasattr(tree, "_fields") and all(
            isinstance(getattr(tree, k), torch.Tensor) for k in tree._fields):
        planes.append(tree)
    else:
        return False
    return True


def _fields(planes: list) -> list:
    """Each plane's field tensors, in ``_fields`` order."""
    return [[getattr(p, k) for k in p._fields] for p in planes]


def _rebound(planes: list, held: list) -> list:
    """``(held tensor, bound tensor)`` for each plane field rebound since
    ``held`` (``_fields``) was taken.  Raises ``ValueError`` where one
    differs from its held tensor in shape, dtype or device."""
    moved = [(h, t) for p, hs in zip(planes, held)
             for h, t in zip(hs, (getattr(p, k) for k in p._fields))
             if h is not t]
    for h, t in moved:
        if (t.shape, t.dtype, t.device) != (h.shape, h.dtype, h.device):
            raise ValueError(f"a plane field of shape {tuple(h.shape)} "
                             f"{h.dtype} was rebound to {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return moved


def _bind(planes: list, held: list) -> None:
    for p, hs in zip(planes, held):
        for k, h in zip(p._fields, hs):
            setattr(p, k, h)


def _copy(pairs: list) -> None:
    """``dst.copy_(src)`` for each ``(dst, src)``: one foreach copy a
    dtype."""
    by_dtype = {}
    for d, t in pairs:
        a, b = by_dtype.setdefault(d.dtype, ([], []))
        a.append(d)
        b.append(t)
    for a, b in by_dtype.values():
        torch._foreach_copy_(a, b)


def written_back(fn, planes: list, *args):
    """``fn(*args)`` with every field of ``planes`` that it rebinds, rather
    than writes in place, written back into the tensor it held before and
    bound to it again, so that the planes keep their tensors: a graph
    captured over the call reads and writes the same tensors on every
    replay.  Raises ``ValueError``, with the old tensors bound back, where
    a field was rebound to a tensor of another shape, dtype or device, or
    to storage that another field holds: the write-back would then change
    what the call means."""
    held = _fields(planes)
    try:
        out = fn(*args)
        moved = _rebound(planes, held)
        ptrs = [t.untyped_storage().data_ptr()
                for t in [h for hs in held for h in hs]
                + [t for _, t in moved]]
        if len(set(ptrs)) < len(ptrs):
            raise ValueError("a plane field was rebound to storage that "
                             "another field holds")
        _copy(moved)
    finally:
        _bind(planes, held)
    return out


def adopt(planes: list, held: list) -> None:
    """Bind the planes' fields back to ``held`` (their tensors when a
    graph was captured), copying in the value of each field rebound since
    (by an eager call).  Raises ``ValueError``, binding nothing, where a
    rebound field's shape, dtype or device differ from its held tensor's."""
    moved = _rebound(planes, held)
    if moved:
        _copy(moved)
        _bind(planes, held)


class Replayed:
    """``fn(params, state, tokens) -> (state, logits)``, a decode step that
    updates its planes in place and returns ``state`` with new ``lengths``,
    replayed from a captured CUDA graph where it may (``may_replay``).

    The first call on a set of params and planes runs eagerly; the next
    call on the same ones is captured on a side stream, with a private
    memory pool, and, since capture runs nothing on the card, replayed at
    once; every later call on them replays.  A replay reads ``tokens`` and
    ``state.lengths`` through the graph's input buffers, filled in place,
    and works on the planes it was captured on: a plane field rebound
    since (``s.step`` by an eager call) is copied back into the tensor the
    graph holds (``adopt``).  It returns ``state`` with ``lengths`` + 1,
    and the logits, both the graph's own output buffers, which the next
    replay overwrites: a caller that keeps either past the next call
    clones it.  A replay first waits until the card has finished the one
    launched ``IN_FLIGHT`` replays before it: the host then runs at most
    one step ahead of the card, so a clock around a call reads the step's
    time, and no queue of launches builds up behind the card (without the
    wait, the launch queue let the host run 256 steps ahead of an H100).
    A call on other params or planes, or with tokens or lengths of another
    shape or dtype, runs eagerly, and the graph is kept.  A capture that
    raises (a host read, a sync) leaves the step eager for its life,
    counted under ``failed``.  ``replay_counts`` tallies captures,
    replays, eager calls and failed captures; the kernel launch counts
    (``ops.launch_counts``) take each replay's launches, those the
    captured call counted, and nothing for the capture.  The
    step holds the params and planes of its graph for its life."""

    def __init__(self, fn, functions: tuple):
        self.fn, self.functions = fn, functions
        self.replay_counts = dict.fromkeys(
            ("captures", "replays", "eager", "failed"), 0)
        self.graph = None
        self.warm = []              # weak refs: the last eager call's leaves
        self.failed = False         # a capture raised: eager for good

    def __call__(self, params, state, tokens):
        may = self._may(state, tokens)
        if may and self.graph is not None and self._bound(params, state,
                                                          tokens):
            return self._replay(state, tokens)
        if self.graph is None:
            leaves = self._leaves(params, state)
            if (may and not self.failed and leaves is not None
                    and self._warmed(leaves)
                    and self._capture(params, state, tokens, leaves)):
                return self._replay(state, tokens)
            self.warm = ([] if leaves is None else
                         [weakref.ref(x) for x in leaves[0] + leaves[1]])
        self.replay_counts["eager"] += 1
        return self.fn(params, state, tokens)

    def _may(self, state, tokens) -> bool:
        return (not isinstance(tokens, DTensor)
                and not isinstance(state.lengths, DTensor)
                and may_replay(tokens.device, self.functions))

    @staticmethod
    def _leaves(params, state):
        """``(param tensors, planes, state tensors)`` of a call; None where
        a leaf is not a tensor or a plane state."""
        p, in_params, planes, s = [], [], [], []
        if (_leaves(params, in_params, p) and not in_params
                and _leaves([state.kv, state.extra], planes, s)):
            return p, planes, s
        return None

    def _warmed(self, leaves) -> bool:
        """Whether the last eager call ran on these params and planes."""
        now = leaves[0] + leaves[1]
        return (len(now) == len(self.warm)
                and all(r() is x for r, x in zip(self.warm, now)))

    def _bound(self, params, state, tokens) -> bool:
        """Whether the call is on the params, planes and state tensors the
        graph was captured on, with tokens and lengths of the captured
        shapes and dtypes; then the planes' rebound fields are adopted."""
        if _meta(tokens) != _meta(self.tok_in) or \
                _meta(state.lengths) != _meta(self.len_in):
            return False
        leaves = self._leaves(params, state)
        if leaves is None or any(
                len(a) != len(b) or not all(map(operator.is_, a, b))
                for a, b in zip(leaves, self.leaves)):
            return False
        try:
            adopt(self.leaves[1], self.held)
        except ValueError:
            return False
        return True

    def _capture(self, params, state, tokens, leaves) -> bool:
        """Capture the step on a side stream; False where the capture
        raised (nothing ran and the planes hold their tensors)."""
        planes = leaves[1]
        tok_in, len_in = tokens.clone(), state.lengths.clone()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        try:
            with torch.cuda.device(tokens.device), torch.cuda.stream(
                    torch.cuda.Stream(tokens.device)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out, logits = written_back(
                        self.fn, planes, params,
                        state._replace(lengths=len_in), tok_in)
                finally:
                    graph.capture_end()
            if out.kv is not state.kv or out.extra is not state.extra:
                raise ValueError("the step returned other planes than it "
                                 "was given")
        except (RuntimeError, ValueError):
            self.failed = True
            self.replay_counts["failed"] += 1
            return False
        finally:
            # the wrappers counted the captured launches, which ran nothing
            launched = {k: n - before[k]
                        for k, n in ops.launch_counts().items()
                        if n != before[k]}
            ops.add_launches({k: -n for k, n in launched.items()})
        self.graph, self.launches = graph, launched
        self.done = [torch.cuda.Event() for _ in range(IN_FLIGHT)]
        self.tok_in, self.len_in = tok_in, len_in
        self.len_out, self.logits = out.lengths, logits
        self.leaves, self.held = leaves, _fields(planes)
        self.warm = []
        self.replay_counts["captures"] += 1
        return True

    def _replay(self, state, tokens):
        done = self.done[self.replay_counts["replays"] % IN_FLIGHT]
        done.synchronize()          # the replay IN_FLIGHT calls back
        self.tok_in.copy_(tokens)
        self.len_in.copy_(state.lengths)
        with trace.span(SPAN):
            self.graph.replay()
        done.record()
        ops.add_launches(self.launches)
        self.replay_counts["replays"] += 1
        return state._replace(lengths=self.len_out), self.logits


def _meta(t: torch.Tensor) -> tuple:
    return t.shape, t.dtype, t.device
