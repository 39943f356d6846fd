"""Deterministic fault model for the far tier (PyTorch port of
``repro.core.faults``).

A seeded, stateless, counter-based schedule: every predicate is a pure
function of ``(seed, tick, key, shard)``.  The device predicates
(:meth:`Schedule.fetch_fail`, :meth:`Schedule.egress_fail`) run on tensors
inside the plan step; the host mirrors (:meth:`Schedule.fails`,
:meth:`Schedule.fails_egress`) evaluate the same bits in numpy.

The murmur-style uint32 hash is computed in int64 with ``& 0xFFFFFFFF``
after every multiply (torch has no uint32 right shift on the CPU); every
intermediate stays below 2**63, so the bits equal the uint32 ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SEED_MUL = 0x9E3779B9
_TICK_MUL = 0x85EBCA6B
_KEY_MUL = 0xC2B2AE35
_SHARD_SALT = 0x01000193
_SPIKE_KEY = 0x5A1AD
_EGRESS_SALT = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _mix(h):
    """32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    h = h ^ (h >> 16)
    return h


def _u32(x):
    """An int (Python or tensor) as its uint32 value: a Python int, or an
    int64 tensor (no host-to-device copy for a Python int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _u01_raw(seed, tick, key: torch.Tensor) -> torch.Tensor:
    h = (((key * _KEY_MUL) & _M32)
         ^ ((_u32(seed) * _SEED_MUL) & _M32)
         ^ ((_u32(tick) * _TICK_MUL) & _M32))
    # uint32 -> f32 rounds to nearest, exactly as the JAX/numpy cast does
    return _mix(h).to(torch.float32) * (2.0 ** -32)


def _np_u01(seed, tick, key) -> np.float32:
    """Host (numpy) evaluation of the same hash."""
    with np.errstate(over="ignore"):
        h = (np.uint32(seed) * np.uint32(_SEED_MUL)
             ^ np.uint32(tick) * np.uint32(_TICK_MUL)
             ^ np.uint32(key) * np.uint32(_KEY_MUL))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x846CA68B)
        h = h ^ (h >> np.uint32(16))
    return np.float32(h) * np.float32(2.0 ** -32)


def _lt_f32(u: torch.Tensor, p: float) -> torch.Tensor:
    """``u < f32(p)``: the comparison JAX makes against a weak Python float."""
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A deterministic fault schedule (frozen, hashable); same fields and
    semantics as ``repro.core.faults.Schedule``."""
    seed: int = 0
    fail_prob: float = 0.0
    fail_window: tuple = ()
    outages: tuple = ()
    fail_at: tuple = ()
    spike_prob: float = 0.0
    spike_us: float = 0.0
    egress_prob: float = 0.0
    egress_window: tuple = ()
    slowdowns: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "outages",
                           tuple(tuple(int(x) for x in w)
                                 for w in self.outages))
        object.__setattr__(self, "fail_at",
                           tuple(int(t) for t in self.fail_at))
        object.__setattr__(self, "fail_window",
                           tuple(int(t) for t in self.fail_window))
        object.__setattr__(self, "egress_window",
                           tuple(int(t) for t in self.egress_window))
        object.__setattr__(self, "slowdowns",
                           tuple((int(w[0]), int(w[1]), int(w[2]),
                                  float(w[3]))
                                 for w in self.slowdowns))
        assert len(self.fail_window) in (0, 2)
        assert len(self.egress_window) in (0, 2)
        assert 0.0 <= self.fail_prob <= 1.0
        assert 0.0 <= self.spike_prob <= 1.0
        assert 0.0 <= self.egress_prob <= 1.0
        assert all(len(w) == 3 for w in self.outages)
        assert all(len(w) == 4 and w[3] >= 0.0 for w in self.slowdowns)

    @property
    def active(self) -> bool:
        """True if any device-side fetch fault can ever fire."""
        return bool(self.fail_prob > 0.0 or self.outages or self.fail_at)

    @property
    def egress_active(self) -> bool:
        """True if any device-side egress (remote-write) fault can fire."""
        return bool(self.egress_prob > 0.0 or self.outages or self.fail_at)

    # ---------------------------------------------------------- device ----
    def in_outage(self, tick, shard, device) -> torch.Tensor:
        """bool []: is ``shard`` inside an outage window at ``tick``?
        ``tick`` and ``shard`` are Python ints or 0-d tensors."""
        hit = torch.zeros((), dtype=torch.bool, device=device)
        for start, end, sh in self.outages:
            cover = (tick >= start) & (tick < end)
            if sh >= 0:
                cover = cover & (shard == sh)
            hit = hit | cover
        return hit

    def _device_fail(self, tick, keys, shard, prob, window, salt_fn):
        fail = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        if prob > 0.0:
            salted = salt_fn(_u32(keys), _u32(shard))
            fail = _lt_f32(_u01_raw(self.seed, tick, salted), prob)
            if window:
                fail = fail & (tick >= window[0]) & (tick < window[1])
        if self.outages:
            fail = fail | self.in_outage(tick, shard, keys.device)
        if self.fail_at:
            hit = torch.zeros((), dtype=torch.bool, device=keys.device)
            for at in self.fail_at:
                hit = hit | (tick == at)
            fail = fail | hit
        return fail

    def fetch_fail(self, tick, keys: torch.Tensor, shard=0) -> torch.Tensor:
        """bool mask, shape of ``keys``: the remote fetch of each key fails
        at ``tick``."""
        return self._device_fail(
            tick, keys, shard, self.fail_prob, self.fail_window,
            lambda k, s: (k + s * _SHARD_SALT) & _M32)

    def egress_fail(self, tick, keys: torch.Tensor, shard=0) -> torch.Tensor:
        """bool mask, shape of ``keys``: the remote write of each key fails
        at ``tick`` (a stream salted apart from :meth:`fetch_fail`)."""
        return self._device_fail(
            tick, keys, shard, self.egress_prob, self.egress_window,
            lambda k, s: ((k ^ _EGRESS_SALT) + s * _SHARD_SALT) & _M32)

    # ------------------------------------------------------------ host ----
    def fails(self, tick: int, key: int = 0, shard: int = 0) -> bool:
        """Host mirror of :meth:`fetch_fail` for a single (tick, key)."""
        if int(tick) in self.fail_at:
            return True
        for start, end, sh in self.outages:
            if start <= int(tick) < end and (sh < 0 or sh == int(shard)):
                return True
        if self.fail_prob > 0.0:
            if self.fail_window and not (
                    self.fail_window[0] <= int(tick) < self.fail_window[1]):
                return False
            salted = ((int(key) & _M32) + int(shard) * _SHARD_SALT) & _M32
            return bool(_np_u01(self.seed, tick, salted)
                        < np.float32(self.fail_prob))
        return False

    def fails_egress(self, tick: int, key: int = 0, shard: int = 0) -> bool:
        """Host mirror of :meth:`egress_fail` for a single (tick, key)."""
        if int(tick) in self.fail_at:
            return True
        for start, end, sh in self.outages:
            if start <= int(tick) < end and (sh < 0 or sh == int(shard)):
                return True
        if self.egress_prob > 0.0:
            if self.egress_window and not (
                    self.egress_window[0] <= int(tick)
                    < self.egress_window[1]):
                return False
            salted = (((int(key) & _M32) ^ _EGRESS_SALT)
                      + int(shard) * _SHARD_SALT) & _M32
            return bool(_np_u01(self.seed, tick, salted)
                        < np.float32(self.egress_prob))
        return False

    def spike(self, tick: int) -> float:
        """Extra dispatch latency (us) injected at this tick; 0 if none."""
        if self.spike_prob <= 0.0:
            return 0.0
        if float(_np_u01(self.seed, tick, _SPIKE_KEY)) < self.spike_prob:
            return float(self.spike_us)
        return 0.0

    def slow_us(self, tick: int, shard: int = -1) -> float:
        """Extra latency (us) from slow-but-alive windows at this tick."""
        worst = 0.0
        for start, end, sh, us in self.slowdowns:
            if not (start <= int(tick) < end):
                continue
            if int(shard) >= 0 and sh >= 0 and sh != int(shard):
                continue
            worst = max(worst, us)
        return worst


NULL = Schedule()
