"""The traffic generator: its arithmetic, its pinned digests, bounded
Zipf, and the open loop's arrivals."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import traffic as tr

CONFIGS = Path(__file__).resolve().parent / "configs"

# the head digest (first 2**20 keys) of each configuration's stream; a card
# run prints the same for the same seed
DIGESTS = {("mcd-cl", 0): "04f879d805a3399b", ("mcd-cl", 1): "935e8627a760f93f"}


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _splitmix_numpy(seed, sid, start, n):
    """SplitMix64 on numpy uint64, the arithmetic's plain statement."""
    with np.errstate(over="ignore"):
        key = np.uint64(tr.mix64_int(tr.mix64_int(seed)
                                     + sid * 0x9E3779B97F4A7C15))
        z = (np.arange(start, start + n, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15) + key)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 12345, 2**40 + 3])
def test_stream_is_splitmix64(seed):
    got = tr.stream(seed, tr.RANK, 1000, 4096, "cpu").numpy().view(np.uint64)
    assert np.array_equal(got, _splitmix_numpy(seed, tr.RANK, 1000, 4096))


def test_stream_known_value():
    # SplitMix64 of state 0x9E3779B97F4A7C15 (the first output from seed 0)
    z = torch.tensor([tr.GAMMA], dtype=torch.int64)
    assert int(tr.mix64(z)) & tr._MASK == 0xE220A8397B1DCDAF


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_digest_pinned(name, seed):
    cfg = _config(name)
    keys = tr.request_keys(cfg["keys"], cfg["objects"], seed, tr.HEAD_KEYS,
                           "cpu")
    assert tr.digest(keys[:tr.HEAD_KEYS]) == DIGESTS[(name, seed)]


def test_prefix_does_not_depend_on_length():
    cfg = _config("mcd-cl")["keys"]
    a = tr.request_keys(cfg, 100_000, 7, 120_000, "cpu")
    b = tr.request_keys(cfg, 100_000, 7, 60_000, "cpu")
    assert torch.equal(a[:60_000], b)


def test_bounded_zipf_ranks():
    """No rank above its bounded probability by more than sampling error;
    the top rank's share is 1/H(n, alpha)."""
    n, alpha, draws = 4096, 1.05, 1 << 20
    cdf = torch.from_numpy(tr.zipf_cdf(n, alpha))
    r = torch.searchsorted(cdf, tr.uniform(tr.stream(5, tr.RANK, 0, draws,
                                                     "cpu")), right=True)
    assert int(r.max()) < n and int(r.min()) >= 0
    p = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    p /= p.sum()
    counts = np.bincount(r.numpy(), minlength=n)
    sigma = np.sqrt(draws * p * (1 - p))
    assert np.all(counts <= draws * p + 6 * sigma + 6)
    assert abs(counts[0] / draws - p[0]) < 6 * sigma[0] / draws


def test_mcd_cl_top_key_is_not_the_clamp():
    """At 8,388,608 keys the most frequent key takes about 1/H(n, 1.05) =
    8.6% of requests, not the 39% of a clamped draw."""
    cfg = _config("mcd-cl")
    n = 8_388_608
    draws = 262_144
    keys = tr.request_keys(cfg["keys"], n, 0, draws, "cpu").numpy()
    top = np.bincount(keys, minlength=n).max() / draws
    p0 = 1.0 / np.sum(np.arange(1, n + 1, dtype=np.float64) ** -1.05)
    assert abs(p0 - 0.0864) < 1e-3
    assert abs(top - p0) < 6 * math.sqrt(p0 * (1 - p0) / draws)
    assert np.unique(keys).size > 75_000     # the clamp left 55,020


def test_churn_remaps_a_tenth():
    cfg = dict(_config("mcd-cl")["keys"], churn_every=1000)
    n = 50_000
    perm = torch.sort(tr.stream(9, tr.PERM, 0, n, "cpu"), stable=True).indices
    before = perm.clone()
    tr._churn(perm, 9, 1, n // 10)
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    moved = int((perm != before).sum())
    assert 0.095 * n <= moved <= n // 10
    keys = tr.request_keys(cfg, n, 9, 3000, "cpu")
    assert keys.shape == (3000,)


def test_uniform_keys_in_range():
    k = tr.uniform_keys(4, tr.FILL, 1000, 0, 100_000, "cpu")
    assert k.dtype == torch.int32
    assert int(k.min()) == 0 and int(k.max()) == 999


def test_poisson_arrivals():
    t = tr.arrivals({"rate_per_s": 50_000}, 11, 10.0)
    assert np.all(np.diff(t) > 0) and t[-1] < 10.0
    assert abs(t.size - 500_000) < 6 * math.sqrt(500_000)
