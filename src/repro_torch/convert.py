"""Plane states to and from numpy, field by field.

``state_to_numpy`` gives the logical arrays (trash rows stripped) with the
JAX package's field names and dtypes, ``stats`` nested as a dict.
``state_from_numpy`` builds a port state from such a mapping, or from any
object with ``_asdict()`` (a ``jax.device_get`` of the JAX ``PlaneState``),
appending the trash rows.  Both take a sharded plane too: a list of shard
states on the port's side, a leading shard axis on the JAX side.  This is
how a state carries across the two frameworks: the tests hand the JAX
plane's state to the port this way.
``kv_state_to_numpy``/``kv_state_from_numpy`` do the same for the KV
plane's ``KVPlaneState``, a list of shard states standing for JAX's
stacked leading shard axis; ``expert_state_*`` for the expert plane, and
``params_from_numpy``/``params_to_numpy``/``serve_state_*`` for the
model's params and serve state of every family, whose per-layer lists
stand for JAX's stacked layer axes (a hybrid group's nested ``mamba`` list
for the second axis of JAX's ``[6, 5, ...]`` leaves);
``opt_state_to_numpy``/``opt_state_from_numpy`` for the optimizers' state
(AdamW's moments, Adafactor's factored statistics).
"""
from __future__ import annotations

import numpy as np
import torch

from .core import expertplane as ep
from .core import kvplane as kv
from .core import state as st
from .core.layout import PlaneConfig
from .models import api


def _as_dict(d) -> dict:
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def _state_np(s: st.PlaneState) -> dict:
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


def state_to_numpy(s) -> dict:
    """A plane state (or a list of shard states, stacked on a leading
    axis) as the JAX ``PlaneState``'s logical numpy arrays."""
    if isinstance(s, (list, tuple)):
        parts = [_state_np(x) for x in s]
        out = {k: np.stack([p[k] for p in parts]) for k in parts[0]
               if k != "stats"}
        out["stats"] = {k: np.stack([p["stats"][k] for p in parts])
                        for k in parts[0]["stats"]}
        return out
    return _state_np(s)


def _state_one(cfg: PlaneConfig, d: dict, dev) -> st.PlaneState:
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


def state_from_numpy(cfg: PlaneConfig, d, device="cuda"):
    """A port plane state from the JAX ``PlaneState``'s fields (a mapping
    or anything with ``_asdict()``); with a leading shard axis (``step``
    of shape ``[S]``), a list of S shard states for the per-shard
    ``cfg``."""
    dev = st.resolve_device(device)
    d = _as_dict(d)
    if np.ndim(d["step"]) == 1:
        stats = _as_dict(d["stats"])
        return [_state_one(cfg, dict(
            {k: np.asarray(v)[i] for k, v in d.items() if k != "stats"},
            stats={k: np.asarray(v)[i] for k, v in stats.items()}), dev)
            for i in range(np.shape(d["step"])[0])]
    return _state_one(cfg, d, dev)


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


# --------------------------------------------------------------------------
# the model's params and serve state (models.api)
# --------------------------------------------------------------------------

def _tensor(a, dev, dtype=None) -> torch.Tensor:
    """A numpy array (ml_dtypes bf16 from JAX too) as a tensor on ``dev``,
    in ``dtype`` if given, else in the array's own dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            dev, dtype or torch.bfloat16)
    x = torch.from_numpy(np.array(a)).to(dev)
    return x if dtype is None else x.to(dtype)


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def _carry(defs, a, dev):
    """JAX params ``a`` in the layout of the port's defs tree ``defs``:
    where ``defs`` holds a list of n layers, JAX's leaves have a leading
    axis of n."""
    if isinstance(defs, list):
        return [_carry(d, _tree(a, lambda x, i=i: np.asarray(x)[i]), dev)
                for i, d in enumerate(defs)]
    if isinstance(defs, dict):
        return {k: _carry(v, a[k], dev) for k, v in defs.items()}
    return _tensor(a, dev)


def params_from_numpy(cfg, jax_params, device="cuda") -> dict:
    """The JAX package's params (nested dicts, stacked leaves) in the
    port's layout: the same key names, every stacked group (``blocks``,
    ``enc_blocks``, ``dec_blocks``, a hybrid group's ``mamba``, ``tail``) a
    list of per-layer dicts, each leaf in its JAX dtype."""
    dev = st.resolve_device(device)
    return _carry(api.model_defs(cfg), jax_params, dev)


def params_to_numpy(cfg, torch_params) -> dict:
    """The port's params in the JAX package's layout: every per-layer list
    stacked on a leading axis (nested lists on several), as numpy arrays
    (bf16 as f32)."""
    return _tree_np(torch_params, None)


def opt_state_to_numpy(cfg, opt_state) -> dict:
    """An optimizer state in JAX's layout: AdamW's ``mu``/``nu`` stacked
    as the params are; Adafactor's ``f`` (already JAX's stacked layout,
    ``optim.optimizers.stacked``) as numpy."""
    return _tree_np(opt_state, None)


def opt_state_from_numpy(cfg, d, device="cuda") -> dict:
    """A port optimizer state from JAX's (AdamW's ``{"mu", "nu"}``, in the
    params' per-layer layout; Adafactor's ``{"f"}``, kept stacked)."""
    dev = st.resolve_device(device)
    if "f" in d:
        return {"f": _tree(d["f"], lambda a: _tensor(a, dev))}
    defs = api.model_defs(cfg)
    return {k: _carry(defs, d[k], dev) for k in ("mu", "nu")}


def _expert_np(s: ep.ExpertPlaneState) -> dict:
    out = {}
    for name in ep.ExpertPlaneState._fields:
        x = s.view(name)
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        out[name] = x.cpu().numpy()
    return out


def expert_state_to_numpy(s) -> dict:
    """An expert plane state (or a list of layer states, stacked on a
    leading axis) as the JAX ``ExpertPlaneState``'s logical numpy arrays."""
    if isinstance(s, (list, tuple)):
        parts = [_expert_np(x) for x in s]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    return _expert_np(s)


def _expert_one(cfg: ep.ExpertPlaneConfig, d: dict, dev) -> ep.ExpertPlaneState:
    s = ep.init(cfg, dev)
    for name in ep.ExpertPlaneState._fields:
        dst = s.view(name)
        dst.copy_(_tensor(d[name], dev, dst.dtype).reshape(dst.shape))
    return s


def expert_state_from_numpy(cfg: ep.ExpertPlaneConfig, d, device="cuda"):
    """A port expert state from the JAX ``ExpertPlaneState``'s fields; with
    a leading layer axis (``step`` of shape ``[L]``), a list of L states."""
    dev = st.resolve_device(device)
    d = _as_dict(d)
    if np.ndim(d["step"]) == 1:
        return [_expert_one(cfg, {k: np.asarray(v)[i] for k, v in d.items()},
                            dev) for i in range(np.shape(d["step"])[0])]
    return _expert_one(cfg, d, dev)


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.cpu().numpy()


def _stack_np(parts: list):
    p0 = parts[0]
    if isinstance(p0, dict):
        return {k: _stack_np([p[k] for p in parts]) for k in p0}
    if isinstance(p0, tuple):
        return tuple(_stack_np([p[i] for p in parts]) for i in range(len(p0)))
    return np.stack(parts)


def _tree_np(x, kvc):
    """A serve state subtree as JAX's arrays: a list is a stacked axis, a
    KV or expert plane state its fields."""
    if isinstance(x, kv.KVPlaneState):
        return _kv_np(kvc, x)
    if isinstance(x, ep.ExpertPlaneState):
        return _expert_np(x)
    if isinstance(x, dict):
        return {k: _tree_np(v, kvc) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_tree_np(v, kvc) for v in x)
    if isinstance(x, list):
        return _stack_np([_tree_np(v, kvc) for v in x])
    return _np(x)


def serve_state_to_numpy(cfg, shape, s, shards: int = 1) -> dict:
    """A port ``ServeState`` as the JAX one's arrays: ``lengths``, ``kv``
    and ``extra`` with every per-layer list stacked on a leading axis (KV
    plane fields ``[L, ...]``, ``[L, D, ...]`` in sparse mode; a hybrid
    group's ``conv``/``ssm`` ``[6, 5, ...]``), bf16 as f32; ``extra`` is
    ``()`` where the family has none."""
    kvc, _ = api.kv_plan(cfg, shape, shards)
    return {"lengths": s.lengths.cpu().numpy(),
            "kv": _tree_np(s.kv, kvc),
            "extra": _tree_np(s.extra, kvc) if len(s.extra) else ()}


def _layers(a, dev, dtype, axes: int = 1):
    """An array with ``axes`` stacked leading axes as nested lists of
    tensors on ``dev`` in ``dtype``."""
    a = np.asarray(a)
    if axes == 0:
        return _tensor(a, dev, dtype)
    return [_layers(a[i], dev, dtype, axes - 1) for i in range(a.shape[0])]


def serve_state_from_numpy(cfg, shape, d, shards: int = 1, device="cuda"):
    """A port ``ServeState`` from the JAX one (a mapping or anything with
    ``_asdict()``, e.g. a ``jax.device_get`` of it), for every family."""
    dev = st.resolve_device(device)
    d = _as_dict(d)
    kvc, _ = api.kv_plan(cfg, shape, shards)
    f32 = torch.float32
    lengths = _tensor(d["lengths"], dev, torch.int32)

    def planes(kvd):
        kvd = _as_dict(kvd)
        return [kv_state_from_numpy(kvc, {k: np.asarray(v)[i]
                                          for k, v in kvd.items()}, dev)
                for i in range(np.shape(kvd["step"])[0])]

    if cfg.family == "ssm":
        k = _as_dict(d["kv"])
        L = np.shape(k["mlstm_s"])[0]
        kvs = [{"mlstm_s": _layers(k["mlstm_s"][i], dev, f32, 0),
                "mlstm_n": _layers(k["mlstm_n"][i], dev, f32, 0),
                "slstm": tuple(_layers(a[i], dev, f32, 0)
                               for a in k["slstm"])} for i in range(L)]
        return api.ServeState(lengths, kvs, ())
    if cfg.family == "hybrid":
        k, t = _as_dict(d["kv"]), _as_dict(d["extra"])
        conv = _layers(k["conv"], dev, cfg.dtype, 2)
        ssm = _layers(k["ssm"], dev, f32, 2)
        kvs = [{"conv": c, "ssm": s, "attn_kv": a}
               for c, s, a in zip(conv, ssm, planes(k["attn_kv"]))]
        tail = {"conv": _layers(t["conv"], dev, cfg.dtype),
                "ssm": _layers(t["ssm"], dev, f32)}
        return api.ServeState(lengths, kvs, tail)
    if cfg.family == "encdec":
        x = _as_dict(d["extra"])
        cross = {n: _layers(x[n], dev, cfg.dtype) for n in ("k", "v")}
        return api.ServeState(lengths, planes(d["kv"]), cross)
    extra = ()
    if api._uses_expert_plane(cfg):
        extra = expert_state_from_numpy(api._expert_cfg(cfg), d["extra"], dev)
    return api.ServeState(lengths, planes(d["kv"]), extra)
