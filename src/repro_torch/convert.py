"""Plane states to and from numpy, field by field.

``state_to_numpy`` gives the logical arrays (trash rows stripped) with the
JAX package's field names and dtypes, ``stats`` nested as a dict.
``state_from_numpy`` builds a port state from such a mapping, or from any
object with ``_asdict()`` (a ``jax.device_get`` of the JAX ``PlaneState``),
appending the trash rows.  This is how a state carries across the two
frameworks: the tests hand the JAX plane's state to the port this way.
``kv_state_to_numpy``/``kv_state_from_numpy`` do the same for the KV
plane's ``KVPlaneState``, a list of shard states standing for JAX's
stacked leading shard axis.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import kvplane as kv
from .core import state as st
from .core.layout import PlaneConfig


def _as_dict(d) -> dict:
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def state_to_numpy(s: st.PlaneState) -> dict:
    out = {}
    for name in st.PlaneState._fields:
        if name == "stats":
            out[name] = {k: v.cpu().numpy()
                         for k, v in s.stats._asdict().items()}
        else:
            x = s.view(name)
            if x.dtype == torch.bfloat16:
                x = x.to(torch.float32)
            out[name] = x.cpu().numpy()
    return out


def state_from_numpy(cfg: PlaneConfig, d, device="cuda") -> st.PlaneState:
    dev = st.resolve_device(device)
    d = _as_dict(d)
    kw = {}
    for name in st.PlaneState._fields:
        if name == "stats":
            stats = _as_dict(d[name])
            kw[name] = st.PlaneStats(**{
                k: torch.from_numpy(np.array(stats[k], np.int32)).to(dev)
                for k in st.PlaneStats._fields})
            continue
        a = np.array(d[name])
        x = torch.from_numpy(a).to(dev)
        if name in ("frames", "slab"):
            x = x.to(cfg.dtype)
        if name in st.PADDED:
            x = torch.cat([x, torch.zeros_like(x[:1])])   # trash row
        kw[name] = x
    return st.PlaneState(**kw)


def _kv_np(cfg: kv.KVPlaneConfig, s: kv.KVPlaneState) -> dict:
    out = {}
    for name in kv.KVPlaneState._fields:
        x = s.view(cfg, name)
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        out[name] = x.cpu().numpy()
    return out


def kv_state_to_numpy(cfg: kv.KVPlaneConfig, s) -> dict:
    """A KV plane state (or a list of shard states, stacked on a leading
    axis) as the JAX ``KVPlaneState``'s logical numpy arrays."""
    if isinstance(s, (list, tuple)):
        parts = [_kv_np(cfg, x) for x in s]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    return _kv_np(cfg, s)


def _kv_one(cfg: kv.KVPlaneConfig, d: dict, dev) -> kv.KVPlaneState:
    s = kv.init(cfg, dev)
    for name in kv.KVPlaneState._fields:
        a = np.asarray(d[name])
        if a.dtype.name == "bfloat16":         # ml_dtypes, from JAX
            a = a.astype(np.float32)
        x = torch.from_numpy(np.array(a)).to(dev)
        dst = s.view(cfg, name)
        dst.copy_(x.to(dst.dtype).reshape(dst.shape))
    return s


def kv_state_from_numpy(cfg: kv.KVPlaneConfig, d, device="cuda"):
    """A port KV state from the JAX ``KVPlaneState``'s fields (a mapping
    or anything with ``_asdict()``); with a leading shard axis (``step``
    of shape ``[D]``), a list of D shard states."""
    dev = st.resolve_device(device)
    d = _as_dict(d)
    if np.ndim(d["step"]) == 1:
        return [_kv_one(cfg, {k: np.asarray(v)[i] for k, v in d.items()},
                        dev) for i in range(np.shape(d["step"])[0])]
    return _kv_one(cfg, d, dev)
