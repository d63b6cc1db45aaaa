"""The port's sharding rule table against the JAX package's, on the CPU.

For every configuration of ``ARCH_IDS``, full and reduced, every
parameter leaf (shapes only: the port's parameters drawn under
``FakeTensorMode``, the reference's by ``jax.eval_shape``) gets its DTensor
placements on the production meshes, (16, 16) and (2, 16, 16), built on a
``fake`` process group; read back as a per-dim spec they must equal the
reference's ``divisible_spec(AbstractMesh(...), spec_for_path(...),
shape)`` exactly.  Also: ``shard_activation`` and ``gather_dp`` are no-ops
without a mesh or on plain tensors, and a dim over ("pod", "data") is
``Shard(d)`` on both mesh dims.
"""
from __future__ import annotations

import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.distributed import sharding as jsh
from repro.models.registry import get_arch as jget_arch
from repro_torch.distributed import sharding as tsh
from repro_torch.models.registry import ARCH_IDS, get_arch

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}
STACKED = ("layers", "enc_layers", "dense_layers")


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    """(port DeviceMesh on a fake process group, JAX AbstractMesh); the
    process group is destroyed after the module's tests on this mesh."""
    shape, names = MESHES[request.param]
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names), AbstractMesh(shape, names)
    finally:
        dist.destroy_process_group()


def _flat(tree, path: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _reference_specs(jarch, amesh) -> dict:
    sds = jax.eval_shape(lambda: jarch.init(jax.random.PRNGKey(0)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]:
        ps = jsh._path_str(path)
        stacked = any(ps.startswith(p) or f"/{p}/" in ps for p in STACKED)
        spec = jsh.spec_for_path(ps, len(leaf.shape), stacked)
        out[ps] = (tuple(leaf.shape), tuple(jsh.divisible_spec(amesh, spec, leaf.shape)))
    return out


def _pair(name: str, reduced: bool):
    jarch, tarch = jget_arch(name), get_arch(name)
    if reduced:
        jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
        tarch = dataclasses.replace(tarch, cfg=tarch.cfg.reduced())
    return jarch, tarch


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_placements_match_reference(meshes, name, reduced):
    mesh, amesh = meshes
    jarch, tarch = _pair(name, reduced)
    want = _reference_specs(jarch, amesh)
    with FakeTensorMode():  # shapes only: nothing is drawn
        params = tarch.init(0, "cpu")
    shapes = {p: tuple(t.shape) for p, t in _flat(params).items()}
    placements = _flat(tsh.param_shardings(mesh, params))
    assert sorted(shapes) == sorted(want)
    for path, (shape, spec) in want.items():
        assert shapes[path] == shape, path
        got = tsh.spec_of_placements(mesh, placements[path], len(shape))
        assert got == spec, (path, got, spec)


def test_pod_and_data_shard_one_dim_on_both_mesh_dims(meshes):
    mesh, amesh = meshes
    if "pod" not in mesh.mesh_dim_names:
        assert tsh.placements_of(mesh, tsh.logical_to_spec(mesh, ("dp", None))) == (
            Shard(0), Replicate())
        return
    pl = tsh.placements_of(mesh, tsh.logical_to_spec(mesh, ("model", "dp")))
    assert pl == (Shard(1), Shard(1), Shard(0))
    assert tsh.spec_of_placements(mesh, pl, 2) == tuple(
        jsh.logical_to_spec(amesh, ("model", "dp")))


def test_input_placements_match_reference(meshes):
    mesh, amesh = meshes
    # the reference's input_shardings is NamedSharding(mesh, logical_to_spec(("dp", None)))
    want = tuple(jsh.logical_to_spec(amesh, ("dp", None)))
    assert tsh.spec_of_placements(mesh, tsh.input_shardings(mesh), 2) == want


def test_shard_activation_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert tsh.current_mesh() is None
    assert tsh.shard_activation(x, "dp", None, "model") is x
    assert tsh.gather_dp(x) is x
    with tsh.mesh_context(None):
        assert tsh.shard_activation(x, "dp", None, None) is x


def test_shard_activation_leaves_plain_tensors_under_a_mesh(meshes):
    mesh, _ = meshes
    x = torch.randn(32, 3, 4)
    with tsh.mesh_context(mesh):
        assert tsh.current_mesh() is mesh
        assert tsh.shard_activation(x, "dp", None, "model") is x
    assert tsh.current_mesh() is None
