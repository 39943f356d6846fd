"""What a traced step costs a rank (the port's counterpart of
``repro.analysis.hlo``, whose HLO parsing has no PyTorch meaning): the
collectives it issues, and its FLOPs.

``TraceCounter`` is a ``TorchDispatchMode``.  For a DTensor op it returns
``NotImplemented``, as ``CommDebugMode`` and ``MemTracker`` do, so DTensor
first turns the op into this rank's local ops and its collectives, which
then come back through the mode.  It records each ``_c10d_functional``
collective (its kind, its bytes and its group size) and counts each local
op's FLOPs with ``torch.utils.flop_counter``'s formulas, the ones
``FlopCounterMode`` applies: over DTensors ``FlopCounterMode`` sees the
global shapes, so its count is the whole step's, not a rank's.  The ops
DTensor runs on fake tensors to propagate shapes pass through uncounted,
as ``MemTracker`` passes them (a fake mode other than the one active on
entry).

``collective_summary`` keeps ``hlo.collective_summary``'s keys and ring
cost models.  The port unrolls layers where JAX scans them, so every
collective a step issues is recorded once per issue: ``bytes_static``
equals ``bytes_corrected`` (there is no loop body to correct for).
"""
from __future__ import annotations

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op -> (kind, index of its group-size argument or None)
_KINDS = {
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_reduce_coalesced_": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_out": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_nbytes(t) for t in x)


def _group_size(group) -> int:
    """The size of the group a collective names (by name, or the group)."""
    if not isinstance(group, str):
        return group.size()
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group).size()


class TraceCounter(TorchDispatchMode):
    """Records this rank's collectives (``records``: dicts of ``kind``,
    ``in_bytes``, ``out_bytes``, ``group``) and counts its FLOPs
    (``flops``) while it is entered."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.flops = 0
        self._fake_on_entry = None

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if active_fake_mode() is not self._fake_on_entry:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" and packet.__name__ not in (
                "wait_tensor", "_wrap_tensor_autograd"):
            out = func(*args, **kwargs)
            self._record(packet.__name__, args, out)
            return out
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        return out

    def _record(self, name: str, args, out) -> None:
        if name not in _KINDS:
            raise ValueError(f"TraceCounter: no cost model for collective "
                             f"_c10d_functional.{name}")
        kind, at = _KINDS[name]
        group = args[at] if at is not None else _group_size(args[-1])
        self.records.append({"kind": kind, "in_bytes": _nbytes(args[0]),
                             "out_bytes": _nbytes(out), "group": int(group)})


def collective_summary(records: list) -> dict:
    """Per-device collective traffic: counts and byte totals per kind, with
    ``hlo.collective_summary``'s ring-cost models (AR 2(n-1)/n, AG/A2A
    (n-1)/n, RS (n-1), CP 1x) over each collective's result bytes, the
    size XLA's HLO gives an instruction."""
    out = {k: {"count": 0, "bytes_static": 0.0, "bytes_corrected": 0.0,
               "wire_bytes_corrected": 0.0} for k in COLLECTIVES}
    for r in records:
        kind, size, n = r["kind"], r["out_bytes"], r["group"]
        if kind == "all-reduce":
            wire = 2.0 * size * (n - 1) / max(n, 1)
        elif kind in ("all-gather", "all-to-all"):
            wire = size * (n - 1) / max(n, 1)
        elif kind == "reduce-scatter":
            wire = size * (n - 1)
        else:
            wire = float(size)
        o = out[kind]
        o["count"] += 1
        o["bytes_static"] += size
        o["bytes_corrected"] += size
        o["wire_bytes_corrected"] += wire
    out["total_wire_bytes_corrected"] = sum(
        v["wire_bytes_corrected"] for v in out.values() if isinstance(v, dict))
    out["total_bytes_corrected"] = sum(
        v["bytes_corrected"] for v in out.values() if isinstance(v, dict))
    return out
