"""The port's sharding specs (``repro_torch.models.sharding``) against the
JAX package's ``PartitionSpec``s, for every registered configuration at
full size, on the production meshes and small ones.

The reference's functions run on ``AbstractMesh(axis_sizes, axis_names)``,
the signature of this jax (its own tests build the mesh the older way,
ROADMAP R2); the port's on ``MeshShape`` of the same sizes and names.
Each port leaf of a layer must carry the reference's spec of the stacked
leaf with the layer axis's entry dropped; every other leaf, every batch,
cache and activation spec is equal entry for entry. Nothing is drawn:
both packages walk their trees abstractly.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import base as RC
from repro.models import sharding as RS
from repro_torch.configs import base as TC
from repro_torch.models import sharding as TS

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "data4": ((4, 1), ("data", "model")),
    "model4": ((1, 4), ("data", "model")),
    "two_by_two": ((2, 2), ("data", "model")),
}
BATCHES = (1, 2, 4, 32, 128, 256)


def meshes(name: str):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), TS.MeshShape(sizes, names)


def ref_leaves(tree) -> dict:
    """{"a/b/c": PartitionSpec} of a reference spec tree."""
    pairs = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {RS._path_str(k): v for k, v in pairs}


def port_leaves(tree) -> list:
    """[(reference path, Spec)] of a port spec tree, a layer's leaves once
    per layer."""
    out = []
    TS.map_with_path(lambda path, spec: out.append((path, spec)), tree)
    return out


@pytest.mark.parametrize("fsdp_on", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_specs_are_the_references_without_the_layer_axis(arch, mesh,
                                                                fsdp_on):
    jmesh, tmesh = meshes(mesh)
    want = ref_leaves(RS.param_specs(RC.get_config(arch), jmesh, fsdp_on))
    got = port_leaves(TS.param_specs(TC.get_config(arch), tmesh, fsdp_on))
    cfg = TC.get_config(arch)
    seen = {}
    for path, spec in got:
        assert isinstance(spec, TS.Spec), path
        w = tuple(want[path])
        if path.startswith("layers/"):
            assert w[0] is None, path
            w = w[1:]
        assert tuple(spec) == w, (path, spec, want[path])
        seen[path] = seen.get(path, 0) + 1
    assert set(seen) == set(want)
    for path, n in seen.items():
        assert n == (cfg.num_layers if path.startswith("layers/") else 1), path


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_activation_specs_match(mesh, batch):
    jmesh, tmesh = meshes(mesh)
    assert TS.batch_axes(tmesh, batch) == RS.batch_axes(jmesh, batch)
    assert TS.fsdp_axes(tmesh) == RS.fsdp_axes(jmesh)
    assert tuple(TS.activation_spec(tmesh, batch)) == \
        tuple(RS.activation_spec(jmesh, batch))
    for arch in TC.ARCH_IDS:
        jcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
        for kind in ("train", "prefill", "decode"):
            seq = 512 if kind != "decode" else 1
            want = RS.batch_specs(RC.batch_struct(jcfg, seq, batch, kind),
                                  jmesh)
            got = TS.batch_specs(TC.batch_shapes(tcfg, seq, batch, kind),
                                 tmesh)
            assert set(got) == set(want), (arch, kind)
            for name, spec in got.items():
                assert tuple(spec) == tuple(want[name]), (arch, kind, name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_specs_match(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    for batch, seq in ((1, 524_288), (4, 4096), (128, 32_768)):
        want = ref_leaves(RS.cache_specs(RC.get_config(arch), jmesh, batch,
                                         seq))
        got = port_leaves(TS.cache_specs(TC.get_config(arch), tmesh, batch,
                                         seq))
        assert sorted(p for p, _ in got) == sorted(want), arch
        for path, spec in got:
            assert tuple(spec) == tuple(want[path]), (batch, seq, path)


def test_axis_helpers_and_spec_type():
    mesh = TS.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert TS.axis_size(mesh, None) == 1
    assert TS.axis_size(mesh, "model") == 16
    assert TS.axis_size(mesh, ("pod", "data")) == 32
    assert TS._maybe(mesh, ("pod", "data"), 64) == ("pod", "data")
    assert TS._maybe(mesh, ("pod", "data"), 48) is None
    assert TS.Spec(("data",), None) == ("data", None)
    assert tuple(PartitionSpec(("data",), None)) == ("data", None)
