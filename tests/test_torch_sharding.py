"""The port's mesh layer against the reference's sharding rules.

Every spec the port derives (default rules, rules per assigned shape,
parameter specs, ZeRO-1 moment specs, cache specs, batch specs) equals the
reference's, leaf for leaf, for all 10 architectures on five meshes, each
spec compared as a tuple. Both sides get the reference's mesh stub
(``axis_names`` and ``devices`` of the mesh's shape), so nothing is
allocated: the reference reads shapes from ``param_specs()`` and
``input_specs()``, the port from meta tensors. On a fake (2, 2, 2) mesh
the DTensor placements of a spec give, on every device, the shard that
XLA's tiling of the same ``PartitionSpec`` gives.
"""
import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import (ASSIGNED_SHAPES, SHAPES_BY_NAME,  # noqa: E402
                                 get_config)
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x16": ((1, 16), ("data", "model")),
}


class StubMesh:
    """The reference tests' mesh stand-in (tests/test_steps_integration.py)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_build(ref_config(arch)).param_specs()


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return build_model(get_config(arch)).init(0, device="meta")


def _ref_leaves(specs):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_leaves(specs, like):
    return [tuple(s) for s in shd.spec_leaves(specs, like)]


def test_registry_matches_reference():
    from repro.configs import SHAPES_BY_NAME as REF_SHAPES

    assert PORT_ARCH_IDS == ARCH_IDS
    assert {k: (s.kind, s.seq_len, s.global_batch)
            for k, s in SHAPES_BY_NAME.items()} == {
        k: (s.kind, s.seq_len, s.global_batch) for k, s in REF_SHAPES.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh_name):
    """default_rules, rules_for each assigned shape, param_specs,
    zero1_specs (m and v have the parameters' shapes), cache_specs
    (decode_32k, long_500k) and batch/token specs, leaf for leaf."""
    shape, axes = MESHES[mesh_name]
    mesh = StubMesh(shape, axes)
    rcfg, cfg = ref_config(arch), get_config(arch)
    assert shd.default_rules(mesh, cfg).rules == \
        ref_shd.default_rules(mesh, rcfg).rules
    rp, pp = _ref_params(arch), _port_params(arch)
    assert [p for p in jax.tree_util.tree_leaves(ref_shd.tree_paths(rp))] \
        == tree_lib.leaves(shd.tree_paths(pp))
    for s in ASSIGNED_SHAPES:
        ref_rules = ref_steps.rules_for(mesh, rcfg, s)
        rules = steps.rules_for(mesh, cfg, s)
        assert rules.rules == ref_rules.rules, s.name
        assert _port_leaves(shd.param_specs(pp, rules, mesh), pp) == \
            _ref_leaves(ref_shd.param_specs(rp, ref_rules, mesh)), s.name
        assert _port_leaves(shd.zero1_specs(pp, rules, mesh), pp) == \
            _ref_leaves(ref_shd.zero1_specs(rp, ref_rules, mesh)), s.name
        ref_inputs = ref_build(rcfg).input_specs(s)
        inputs = steps.input_specs(cfg, s)
        if s.kind == "decode":
            assert _port_leaves(steps.cache_specs(
                inputs["caches"], rules, mesh), inputs["caches"]) == \
                _ref_leaves(ref_steps.cache_specs(
                    ref_inputs["caches"], ref_rules, mesh)), s.name
            assert steps.token_spec(rules, mesh, s.global_batch) == tuple(
                ref_rules.spec(("batch", None), shape=(s.global_batch, 1),
                               axis_sizes=dict(zip(axes, shape))))
        else:
            ref_b = ref_steps.batch_specs(ref_inputs, mesh, ref_rules)
            port_b = steps.batch_specs(inputs, mesh, rules)
            assert sorted(port_b) == sorted(ref_b)
            assert {k: tuple(v) for k, v in port_b.items()} == \
                {k: tuple(v) for k, v in ref_b.items()}, s.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_for_every_leaf_path(arch):
    pp = _port_params(arch)
    for path, leaf in zip(tree_lib.leaves(shd.tree_paths(pp)),
                          tree_lib.leaves(pp)):
        assert shd.logical_axes_for(path, leaf.dim()) == \
            ref_shd.logical_axes_for(path, leaf.dim()), path


def test_rule_table_is_the_reference_s():
    assert shd._PARAM_RULES == ref_shd._PARAM_RULES
    assert steps._CACHE_RULES == ref_steps._CACHE_RULES


_NAMES = ["batch", "seq", "heads", "kv_heads", "ffn", "experts", "vocab",
          None, "embed"]
_AXES = [None, "data", "model", "pod", ("pod", "data"), ("data", "model"),
         ("pod", "data", "model")]


@settings(max_examples=300, deadline=None)
@given(rules=st.dictionaries(st.sampled_from(_NAMES[:-2] + ["embed"]),
                             st.sampled_from(_AXES)),
       names=st.lists(st.sampled_from(_NAMES), min_size=0, max_size=5),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 24, 32, 48]),
                     min_size=5, max_size=5),
       sizes=st.tuples(st.sampled_from([1, 2, 4]), st.sampled_from([1, 2, 16]),
                       st.sampled_from([1, 2, 8, 16])),
       guarded=st.booleans())
def test_spec_matches_reference(rules, names, dims, sizes, guarded):
    axis_sizes = dict(zip(("pod", "data", "model"), sizes))
    shape = dims[:len(names)]
    kw = dict(shape=shape, axis_sizes=axis_sizes) if guarded else {}
    ours = shd.ShardingRules(rules).spec(names, **kw)
    theirs = ref_shd.ShardingRules(rules).spec(names, **kw)
    assert isinstance(ours, tuple)
    assert ours == tuple(theirs)


# ---------------------------------------------------------------------------
# DTensor placements on a fake (2, 2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_mesh():
    mesh_lib.init_group("fake", 8)
    try:
        yield mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                 device="cpu")
    finally:
        mesh_lib.destroy_group()


def _xla_shards(spec, shape, mesh_shape, axes):
    """{device id: (local shape, offset)} from XLA's tiling of ``spec``."""
    am = jax.sharding.AbstractMesh(mesh_shape, axes)
    hlo = jax.sharding.NamedSharding(
        am, jax.sharding.PartitionSpec(*spec))._to_xla_hlo_sharding(
            len(shape))
    if hlo.is_replicated():
        return {d: (tuple(shape), (0,) * len(shape))
                for d in range(int(np.prod(mesh_shape)))}
    tiles = hlo.tile_assignment_dimensions()
    devs = np.asarray(hlo.tile_assignment_devices()).reshape(tiles)
    out = {}
    for idx in itertools.product(*(range(t) for t in tiles)):
        size = [n // t for n, t in zip(shape, tiles)]
        out[int(devs[idx])] = (tuple(size), tuple(
            i * s for i, s in zip(idx[:len(shape)], size)))
    return out


def _dtensor_shards(spec, shape, mesh):
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)

    pl = shd.placements(spec, len(shape), mesh)
    mshape = tuple(mesh.shape)
    out = {}
    for d, coord in enumerate(itertools.product(*(range(n) for n in mshape))):
        size, off = _compute_local_shape_and_global_offset(
            shape, mshape, list(coord), pl)
        out[d] = (tuple(size), tuple(off))
    return out


def _specs_to_check():
    cases = [(("pod", "data"), (16, 8)), ((("pod", "data"), "model"), (8, 4)),
             ((None, ("pod", "data", "model")), (3, 16)),
             (("data", None, "model"), (4, 3, 6)), (("model",), (6, 4)),
             ((), (5, 7)), ((None, ("data", "model")), (2, 8, 3))]
    mesh = StubMesh((2, 2, 2), ("pod", "data", "model"))
    for arch in ("granite_moe_1b_a400m", "jamba_v01_52b", "phi4_mini_3_8b"):
        from repro_torch.configs import get_smoke_config

        cfg = get_smoke_config(arch)
        params = build_model(cfg).init(0, device="meta")
        rules = steps.rules_for(mesh, cfg)
        for spec_tree in (shd.param_specs(params, rules, mesh),
                          shd.zero1_specs(params, rules, mesh)):
            for spec, leaf in zip(shd.spec_leaves(spec_tree, params),
                                  tree_lib.leaves(params)):
                cases.append((spec, tuple(leaf.shape)))
    return cases


def test_placements_give_xla_shards(fake_mesh):
    n = 0
    for spec, shape in _specs_to_check():
        ours = _dtensor_shards(spec, shape, fake_mesh)
        theirs = _xla_shards(spec, shape, (2, 2, 2), ("pod", "data", "model"))
        assert ours == theirs, (spec, shape)
        n += 1
    assert n > 50


def test_placements_refuse_an_order_dtensor_cannot_split(fake_mesh):
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements((("data", "pod"),), 1, fake_mesh)


def test_distribute_keeps_local_shards(fake_mesh):
    x = torch.empty(8, 4, device="meta")
    dt = shd.distribute(x, fake_mesh, (("pod", "data"), "model"))
    assert tuple(dt.shape) == (8, 4)
    assert tuple(dt.to_local().shape) == (2, 2)
    # a mesh axis of size 1 splits nothing: replicated, same layout
    assert all(p.is_replicate() for p in shd.placements(
        ("data", "model"), 2, StubMesh((1, 1), ("data", "model"))))


def test_constrain_is_identity_outside_rules():
    x = torch.randn(2, 3)
    assert shd.constrain(x, "batch", "embed") is x


def test_constrain_lays_out_inside_rules(fake_mesh):
    x = torch.empty(8, 6, 4, device="meta")
    rules = shd.ShardingRules({"batch": ("pod", "data"), "embed": "model"})
    with shd.use_rules(fake_mesh, rules):
        y = shd.constrain(x, "batch", None, "embed")
    assert tuple(y.to_local().shape) == (2, 6, 2)
    assert shd.active() is None


def test_axis_sizes_reads_both_kinds_of_mesh(fake_mesh):
    assert mesh_lib.axis_sizes(fake_mesh) == {"pod": 2, "data": 2,
                                              "model": 2}
    assert mesh_lib.axis_sizes(StubMesh((16, 16), ("data", "model"))) == {
        "data": 16, "model": 16}


def test_a_mesh_of_another_size_than_the_group_raises(fake_mesh):
    with pytest.raises(ValueError, match="world size 8"):
        mesh_lib.make_mesh((4, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="world size 8"):
        mesh_lib.make_production_mesh(device="cpu")
