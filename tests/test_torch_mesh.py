"""The port's model-mesh layout (``repro_torch.launch.mesh``) and spec
trees (``repro_torch.models.api``) against the JAX package.

* ``resolve`` equals JAX's ``resolve`` for every leaf of every arch's
  ``param_pspecs``, in both layouts, on a 2- and a 3-axis mesh (JAX meshes
  of one device; the port's over a fake process group of one rank);
* the placements a spec resolves to, and the specs they refuse;
* ``make_production_mesh``/``make_host_mesh`` over fake process groups of
  1, 8, 24, 256 and 512 ranks, shaped by JAX's rule, and the host mesh's
  refusal past the ranks there are;
* ``param_pspecs``, ``opt_state_pspecs`` (AdamW and Adafactor),
  ``batch_specs`` (shapes, dtypes, specs) and ``serve_state_pspecs`` for
  every arch and shape against JAX's, leaf for leaf: a list of layers in
  the port is JAX's leading layer axis (``None``), a ``PerShard`` list
  JAX's shard axis (``"dp"``).
"""
import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jcfgs
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.tree import flatten_with_path

LAYOUTS = ("2d", "fsdp")


@pytest.fixture
def layout():
    """Sets both packages' layout for a test; restores the default."""
    def set_(name):
        jmesh.set_layout(name)
        tmesh.set_layout(name)
    yield set_
    set_("2d")


@pytest.fixture(scope="module")
def meshes():
    """{axes: (JAX mesh, port mesh)} for the 2- and 3-axis meshes (the
    port's keep their axis names after their fake group is gone)."""
    with dryrun.fake_world(1):
        return {
            2: (jax.make_mesh((1, 1), ("data", "model")),
                tmesh.make_production_mesh(device_type="cpu")),
            3: (jax.make_mesh((1, 1, 1), ("pod", "data", "model")),
                tmesh.make_production_mesh(multi_pod=True,
                                           device_type="cpu")),
        }


def _spec_leaves(tree, path=()):
    """(path, spec) pairs of a spec tree; a list index in the path is an
    int (a ``PerShard`` index a ``("shard", i)`` pair)."""
    if tmesh.is_spec(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _spec_leaves(getattr(tree, k), path + (k,))
    elif isinstance(tree, tapi.PerShard):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (("shard", i),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (f"t{i}",))


def _jax_at(tree, path):
    """JAX's spec at the port's ``path``: list indices become leading
    axes (a layer ``None``, a shard ``"dp"``)."""
    lead = ()
    for k in path:
        if isinstance(k, int):
            lead += (None,)
        elif isinstance(k, tuple):
            lead += ("dp",)
        elif isinstance(k, str) and k.startswith("t") and k[1:].isdigit():
            tree = tree[int(k[1:])]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, k)
        else:
            tree = tree[k]
    return lead, tree


def _same_specs(port, jax_tree, what):
    n = 0
    for path, spec in _spec_leaves(port):
        lead, want = _jax_at(jax_tree, path)
        got = lead + (tuple(spec) if spec is not None else ())
        want = tuple(want) if want is not None else ()
        assert got == want, (what, path, got, want)
        n += 1
    assert n > 0, what


# --------------------------------------------------------------------------
# resolve and placements
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [2, 3])
@pytest.mark.parametrize("name", LAYOUTS)
def test_resolve_matches_jax_for_every_param(meshes, layout, name, axes):
    layout(name)
    jm, tm = meshes[axes]
    for arch in tcfgs.ARCHS:
        for path, spec in _spec_leaves(tapi.param_pspecs(
                tcfgs.get_config(arch))):
            assert tmesh.resolve(tm, spec) == tuple(jmesh.resolve(jm, spec)), \
                (arch, path, spec)


def test_placements_translate_specs(meshes, layout):
    _, m2 = meshes[2]
    _, m3 = meshes[3]
    R = Replicate()
    assert tmesh.placements(m2, ("dp", "tp")) == [Shard(0), Shard(1)]
    assert tmesh.placements(m2, ("tp", "dp")) == [Shard(1), Shard(0)]
    assert tmesh.placements(m3, ("tp", "dp")) == [Shard(1), Shard(1),
                                                  Shard(0)]
    assert tmesh.placements(m3, ("batch", None, None)) == [Shard(0),
                                                           Shard(0), R]
    assert tmesh.placements(m3, (None,)) == [R, R, R]
    assert tmesh.placements(m3, None) == [R, R, R]
    tree = tmesh.sharding_tree(m2, {"a": [("dp", None)], "b": None})
    assert tree == {"a": [[Shard(0), R]], "b": [R, R]}
    layout("fsdp")
    assert tmesh.placements(m3, ("tp", "dp")) == [Shard(1)] * 3
    assert tmesh.placements(m2, ("dp", "tp")) == [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="two dimensions"):
        tmesh.placements(m2, ("dp", "dp"))
    with pytest.raises(ValueError, match="major-to-minor"):
        tmesh.placements(m3, (("model", "data"),))


# --------------------------------------------------------------------------
# meshes over fake process groups
# --------------------------------------------------------------------------

def _jax_rule(n, multi_pod):
    """JAX's make_production_mesh shape for n devices (its arithmetic)."""
    if multi_pod:
        pods = 2 if n % 2 == 0 and n >= 2 else 1
        model = np.gcd(n // pods, 16)
        return {"pod": pods, "data": n // pods // model, "model": model}
    model = np.gcd(n, 16)
    return {"data": n // model, "model": model}


@pytest.mark.parametrize("world", [1, 8, 24, 256, 512])
def test_meshes_over_fake_groups(world):
    with dryrun.fake_world(world):
        for multi in (False, True):
            m = tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
            assert dryrun._mesh_shape(m) == _jax_rule(world, multi)
        h = tmesh.make_host_mesh(1, world, device_type="cpu")
        assert dryrun._mesh_shape(h) == {"data": 1, "model": world}
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_host_mesh(world + 1, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device_type="cpu")


# --------------------------------------------------------------------------
# spec trees against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_param_and_opt_state_specs_match_jax(arch):
    tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
    _same_specs(tapi.param_pspecs(tc), japi.param_pspecs(jc), "params")
    for name in ("adamw", "adafactor"):
        _same_specs(tapi.opt_state_pspecs(tc, name),
                    japi.opt_state_pspecs(jc, name), name)
    # the meta tensors are JAX's shapes and dtypes, layer by layer
    for path, m in flatten_with_path(tapi.param_shapes(tc)):
        lead, want = _jax_at(japi.param_shapes(jc), path)
        assert m.is_meta and (len(lead) + m.dim()) == len(want.shape)
        assert tuple(m.shape) == tuple(want.shape[len(lead):]), path
        assert str(m.dtype).split(".")[-1] == str(want.dtype), path


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_batch_and_serve_state_specs_match_jax(arch):
    tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
    for sname, shape in tcfgs.SHAPES.items():
        jshape = jcfgs.SHAPES[sname]
        tb, jb = tapi.batch_specs(tc, shape), japi.batch_specs(jc, jshape)
        assert sorted(tb) == sorted(jb)
        for k in tb:
            m, spec = tb[k]
            assert m.is_meta and tuple(m.shape) == tuple(jb[k][0].shape), k
            assert str(m.dtype).split(".")[-1] == str(jb[k][0].dtype), k
            assert spec == jb[k][1], (sname, k)
        if shape.kind in ("decode", "decode_long"):
            shards = 16 if shape.kind == "decode_long" else 1
            port = tapi.serve_state_pspecs(tc, shape, shards)
            _same_specs(port, japi.serve_state_pspecs(jc, jshape, shards),
                        (arch, sname))
