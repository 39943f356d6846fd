"""The sharded exchange's phase probe (``core.shardplane.phase_probe``,
JAX's ``jitted_phase_probe``) against JAX's ``shardplane._probe_body``
under ``jax.vmap`` over the ``far`` axis, at S = 1, 2 and 4 shards, for
both phases, with a budget that spills (several rounds) and one that does
not: the per-shard checksums equal.  The mesh path over gloo is held to
the loop oracle in ``tests/test_torch_shardmesh.py``."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shardplane as jsp
from repro.core.layout import PlaneConfig as JConfig
from repro_torch.core import shardplane as tsp
from repro_torch.core.layout import PlaneConfig

O, D, R = 256, 8, 16
PLANE = dict(num_objs=O, obj_dim=D, page_objs=4, num_frames=48,
             num_vpages=192)


@pytest.mark.parametrize("budget", [None, 3])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("phase", ["pack", "ingress"])
def test_phase_probe_matches_jax(phase, shards, budget):
    jc = jsp.make_config(JConfig(**PLANE), shards, R, budget)
    tc = tsp.make_config(PlaneConfig(**PLANE), shards, R, budget)
    assert tc.rounds == jc.rounds
    rng = np.random.default_rng(shards + 7 * (budget or 0))
    ids = (rng.zipf(1.5, size=(shards, R)) % O).astype(np.int32)
    ids[:, -2:] = -1
    want = jax.vmap(partial(jsp._probe_body, jc, phase), axis_name="far")(
        jnp.asarray(ids)[:, None, :])
    got = tsp.phase_probe(tc, phase)(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, 0])


def test_phase_probe_names_its_phases():
    tc = tsp.make_config(PlaneConfig(**PLANE), 2, R)
    with pytest.raises(ValueError, match="pack"):
        tsp.phase_probe(tc, "serve")
