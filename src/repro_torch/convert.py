"""Plane state to and from numpy, field by field.

``state_to_numpy`` gives the logical arrays (trash rows stripped) with the
JAX package's field names and dtypes, ``stats`` nested as a dict.
``state_from_numpy`` builds a port state from such a mapping, or from any
object with ``_asdict()`` (a ``jax.device_get`` of the JAX ``PlaneState``),
appending the trash rows.  This is how a state carries across the two
frameworks: the tests hand the JAX plane's state to the port this way.
"""
from __future__ import annotations

import numpy as np
import torch

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
