"""The benchmark's one traffic generator.

Every random number comes from SplitMix64, computed here on int64 tensors
with wrapping arithmetic (counter-based: value ``i`` of a stream is
``mix64(key + i * GAMMA)``), so one seed gives the same keys on every
numpy and torch version and on the CPU and the card alike.  A cell's
traffic is two data files: the configuration's ``keys`` (which keys a
request reads) and the traffic mix (how requests arrive).

Keys: a request reads one key; ranks are drawn from Zipf(``alpha``)
bounded to the ``objects`` keys, by inverse CDF over a float64 table (no
clamp: the tail past ``n`` is not folded onto the last key).  A rank maps
to a key through a random permutation, and every ``churn_every``
requests a ``churn_fraction`` of the ranks are remapped (a cyclic shift
over ranks drawn without replacement): the drifting hot set of MCD-CL.

Arrivals: a closed loop takes requests as fast as the engine does; an
open loop offers them as a Poisson process at ``rate_per_s`` arrivals a
second.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

_MASK = (1 << 64) - 1


def _signed(x: int) -> int:
    x &= _MASK
    return x - (1 << 64) if x >> 63 else x


GAMMA = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)

# stream ids: each purpose draws from its own counter range
PERM, RANK, CHURN, FILL, ARRIVAL, SAMPLE = 1, 2, 3, 4, 5, 6
HEAD_KEYS = 1 << 20          # the digest's head: the first 2**20 keys


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finaliser on int64 tensors (wrapping arithmetic)."""
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


def mix64_int(z: int) -> int:
    """The same finaliser on a Python int (unsigned 64-bit)."""
    z &= _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def stream(seed: int, sid: int, start: int, n: int, device) -> torch.Tensor:
    """Values ``start .. start+n-1`` of stream ``sid`` of ``seed``, int64."""
    key = mix64_int(mix64_int(seed) + sid * 0x9E3779B97F4A7C15)
    c = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return mix64(c * GAMMA + _signed(key))


def uniform(x: torch.Tensor) -> torch.Tensor:
    """float64 in [0, 1) from the top 53 bits."""
    return _srl(x, 11).to(torch.float64) * 2.0 ** -53


def below(x: torch.Tensor, n: int) -> torch.Tensor:
    """Integers in [0, n) from the top 53 bits (bias under n / 2**53)."""
    return _srl(x, 11) % n


def zipf_cdf(n: int, alpha: float) -> np.ndarray:
    """The CDF of Zipf(``alpha``) bounded to ranks 0 .. n-1 (float64; the
    last entry exactly 1, so every draw in [0, 1) lands on a rank)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    cdf[-1] = 1.0
    return cdf


def _churn(perm: torch.Tensor, seed: int, c: int, k: int) -> None:
    """Remap ``k`` ranks of ``perm`` in place: distinct ranks drawn in a
    random order, each taking the unit of the one before it (a cycle)."""
    n = perm.shape[0]
    m = k + k // 8 + 64
    draw = below(stream(seed, CHURN, (c - 1) * m, m, perm.device), n)
    order = torch.sort(draw, stable=True).indices
    s = draw[order]
    first = torch.ones(m, dtype=torch.bool, device=perm.device)
    first[1:] = s[1:] != s[:-1]
    keep = torch.zeros(m, dtype=torch.bool, device=perm.device)
    keep[order[first]] = True
    idx = draw[keep][:k]
    perm[idx] = perm[torch.roll(idx, 1)]


def request_keys(keys: dict, objects: int, seed: int, n_req: int,
                 device) -> torch.Tensor:
    """The keys of requests ``0 .. n_req-1``: int32 ``[n_req]``.  A prefix
    does not depend on ``n_req``."""
    cdf = torch.from_numpy(zipf_cdf(objects, keys["alpha"])).to(device)
    ranks = torch.searchsorted(cdf, uniform(stream(seed, RANK, 0, n_req,
                                                   device)), right=True)
    del cdf
    perm = torch.sort(stream(seed, PERM, 0, objects, device),
                      stable=True).indices
    every = int(keys["churn_every"])
    k = int(objects * float(keys["churn_fraction"]))
    out = torch.empty_like(ranks)
    for c, a in enumerate(range(0, n_req, every)):
        if c and k:
            _churn(perm, seed, c, k)
        out[a:a + every] = perm[ranks[a:a + every]]
    return out.to(torch.int32)


def uniform_keys(seed: int, sid: int, objects: int, start: int, n: int,
                 device) -> torch.Tensor:
    """``n`` keys drawn uniformly from ``objects`` (int32)."""
    return below(stream(seed, sid, start, n, device), objects).to(torch.int32)


def arrivals(mix: dict, seed: int, horizon_s: float) -> np.ndarray:
    """Arrival times (s, float64, increasing) in ``[0, horizon_s)`` of the
    open loop: a Poisson process at ``rate_per_s``."""
    rate = float(mix["rate_per_s"])
    mean = rate * horizon_s
    n_max = int(1.2 * mean + 10.0 * math.sqrt(mean) + 16)
    u = uniform(stream(seed, ARRIVAL, 0, n_max, "cpu")).numpy()
    t = np.cumsum(-np.log1p(-u)) / rate     # unit-rate gaps, scaled
    return t[t < horizon_s]


def digest(keys: torch.Tensor) -> str:
    """sha256 of the keys as little-endian int32, first 16 hex digits."""
    a = keys.detach().to("cpu").numpy().astype("<i4", copy=False)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]
