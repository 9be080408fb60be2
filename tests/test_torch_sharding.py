"""The port's mesh descriptions and sharding rules against the JAX package.

``repro_torch.distributed.sharding`` is divisibility arithmetic over a
``launch.mesh.MeshSpec``; the reference's is the same arithmetic over a
``jax.sharding.Mesh``.  An ``AbstractMesh`` of the reference's pod
layouts needs no devices, so every arch and shape is held here leaf by
leaf: the reference's ``param_sharding`` over its own
``abstract_params`` (``jax.eval_shape``) against the port's over its
``abstract_params`` (the meta device), ``batch_sharding`` over each
cell's input specs, and ``spec_for`` on a grid of shapes.  Specs are
compared as tuples (the reference's ``PartitionSpec`` entries).
``constrain`` returns its input unchanged, as the reference's does
without a mesh.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.distributed import constraints, sharding
from repro_torch.launch import mesh, steps

pytestmark = pytest.mark.torch_port

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(n, s) for n in list_archs() for s in get_arch(n).shapes]


def _meshes(name):
    sizes, axes = MESHES[name]
    return (AbstractMesh(sizes, axes),
            mesh.make_production_mesh(multi_pod=name == "multi"))


def _jflat(tree):
    """{path: spec tuple} of a reference tree of NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsharding._path_str(p): tuple(s.spec) for p, s in leaves}


def _flat(tree, path=()):
    """{path: spec tuple} of a port tree of spec tuples (a spec is a
    tuple whose entries are axis names, tuples of them, or None)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    return {"/".join(path): tuple(tree)}


@functools.lru_cache(maxsize=None)
def _jparams(name, shape):
    return jsteps.abstract_params(jget_arch(name), shape)


@functools.lru_cache(maxsize=None)
def _params(name, shape):
    return steps.abstract_params(get_arch(name), shape)


def test_production_meshes_match_the_reference_layouts():
    for name, (sizes, axes) in MESHES.items():
        jm, pm = _meshes(name)
        assert pm.axis_names == axes and pm.sizes == sizes
        assert pm.shape == dict(jm.shape) and pm.size == jm.size
        assert pm.devices == ()
        assert mesh.dp_axes(pm) == jmesh.dp_axes(jm)
        assert mesh.mp_axis(pm) == jmesh.mp_axis(jm)
        for axes_arg in (None, "model", ("pod", "data")[-len(axes) + 1:],
                         mesh.dp_axes(pm)):
            assert mesh.axis_size(pm, axes_arg) == jmesh.axis_size(
                jm, axes_arg)
        # the reference's describe() with the size an AbstractMesh has in
        # the place of ``mesh.devices.size``, which it lacks
        assert mesh.describe(pm) == (
            f"mesh axes={dict(jm.shape)} devices={jm.size} "
            f"dp={jmesh.axis_size(jm, jmesh.dp_axes(jm))} "
            f"mp={jmesh.axis_size(jm, jmesh.mp_axis(jm))}")


def test_local_mesh_covers_the_devices_it_is_given():
    cpu = [torch.device("cpu")] * 4
    m = mesh.make_local_mesh(2, devices=cpu)
    assert m.shape == {"data": 2, "model": 2} and len(m.devices) == 4
    assert mesh.make_local_mesh(9, devices=cpu).shape == {"data": 1,
                                                          "model": 4}
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_local_mesh()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_for_matches_reference_on_a_grid(mesh_name):
    jm, pm = _meshes(mesh_name)
    logicals = list(sharding.LOGICAL_RULES) + [None, "unknown"]
    assert sharding.LOGICAL_RULES == jsharding.LOGICAL_RULES
    dims = (1, 2, 3, 16, 32, 48, 256, 512, 4096, 5000)
    for a in logicals:
        for b in logicals:
            for d0 in dims:
                for d1 in dims[::3]:
                    got = sharding.spec_for((a, b), (d0, d1), pm)
                    want = tuple(jsharding.spec_for((a, b), (d0, d1), jm))
                    assert got == want, (a, b, d0, d1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,shape", CELLS)
def test_param_sharding_matches_reference(name, shape, mesh_name):
    """Leaf by leaf, with and without the data-axis (fsdp) sharding."""
    jm, pm = _meshes(mesh_name)
    family = get_arch(name).family
    jp, pp = _jparams(name, shape), _params(name, shape)
    for drop in (False, True):
        want = _jflat(jsharding.param_sharding(jp, jm, family,
                                               drop_fsdp=drop))
        got = _flat(sharding.param_sharding(pp, pm, family, drop_fsdp=drop))
        assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,shape", CELLS)
def test_batch_sharding_matches_reference(name, shape, mesh_name):
    """Every cell's inputs over the batch axes and over every axis
    (``batch_all``), and the ssh query replicated by an override."""
    jm, pm = _meshes(mesh_name)
    _, jbatch = jget_arch(name).input_specs(shape)
    _, batch = get_arch(name).input_specs(shape)
    if "cache" in batch:
        jbatch, batch = jbatch["tokens"], batch["tokens"]
    for logical in ("batch", "batch_all"):
        want = _jflat(jsharding.batch_sharding(
            jbatch, jm, {"query": jax.sharding.PartitionSpec()}, logical))
        got = _flat(sharding.batch_sharding(batch, pm, {"query": ()},
                                            logical))
        assert got == want


def test_constrain_is_the_identity():
    x = torch.arange(64.0).reshape(4, 16)
    assert constraints.constrain(x, "batch", None) is x
    assert constraints.active_mesh() is None
    production = mesh.make_production_mesh()
    with constraints.activation_sharding(production):
        assert constraints.active_mesh() is production
        assert constraints.constrain(x, "batch", "vocab") is x
    assert constraints.active_mesh() is None
