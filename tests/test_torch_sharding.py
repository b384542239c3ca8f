"""The port's sharding rules (``repro_torch.parallel.sharding`` and
``launch/mesh.py``'s ``make_rules``) against the reference's: the rule
tables, and ``spec_for`` with its fallbacks for every param of every
arch's ``logical_axes()`` (full widths, from the reference's abstract
init), on stand-in meshes of shapes (16, 16) and (2, 16, 16), with the
small and the large param tables and each arch's own rules.  The port's
``logical_axes`` and param shapes equal the reference's for every arch;
``constraint`` is the identity (the port has no sharded
tensor type).  On the meta production meshes (``make_production_mesh``),
every param leaf's ``Placement.shard_shape`` from ``tree_param_shardings``
equals the reference's ``NamedSharding.shard_shape`` (on a jax
``AbstractMesh`` of the same shape), and ``sharding_for`` holds the
reference's spec, or ``None`` without rules."""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import Mesh  # noqa: E402
from repro_torch.launch.mesh import make_rules  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
TABLES = ["PARAM_RULES_SMALL", "PARAM_RULES_LARGE", "ACT_RULES_SMALL"]


def stand_in(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


def _ref_axes_and_shapes(arch):
    model = ref_build(ref_registry.get_config(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    axes = model.logical_axes()
    leaves_s, treedef = jax.tree.flatten(shapes)
    leaves_a = treedef.flatten_up_to(axes)
    return axes, [tuple(s.shape) for s in leaves_s], leaves_a


@pytest.fixture(scope="module")
def reference_axes():
    return {a: _ref_axes_and_shapes(a) for a in registry.list_archs()}


def test_rule_tables_equal_the_reference():
    for name in ("ACT_RULES_SMALL", "ACT_RULES_LARGE", "PARAM_RULES_SMALL",
                 "PARAM_RULES_LARGE"):
        assert getattr(sharding, name) == getattr(ref_sharding, name), name


@pytest.mark.parametrize("arch", registry.list_archs())
@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
def test_spec_for_equals_the_reference(arch, mesh, reference_axes):
    _, shapes, axes = reference_axes[arch]
    m = stand_in(MESHES[mesh])
    cfg = registry.get_config(arch)
    rules = make_rules(cfg, m, log_fallbacks=True)
    ref_rules = ref_mesh.make_rules(ref_registry.get_config(arch), m,
                                    log_fallbacks=True)
    assert dict(rules.act) == dict(ref_rules.act)
    assert dict(rules.params) == dict(ref_rules.params)
    assert rules.log_fallbacks and rules.axis_size("pod") == \
        ref_rules.axis_size("pod")
    tables = [(getattr(sharding, t), getattr(ref_sharding, t))
              for t in TABLES] + [(rules.params, ref_rules.params),
                                  (rules.act, ref_rules.act)]
    for table, ref_table in tables:
        got_fb, want_fb = [], []
        for shape, ax in zip(shapes, axes):
            got = sharding.spec_for(shape, ax, table, m, got_fb)
            want = ref_sharding.spec_for(shape, ax, ref_table, m, want_fb)
            assert isinstance(got, tuple)
            assert got == tuple(want), (shape, ax)
        assert got_fb == want_fb


def _stacked_shapes(prefix: str, tree: dict, L: int) -> dict:
    """A layer's (nested) param dict as {dotted path: (L, *shape)}."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_stacked_shapes(f"{prefix}.{key}", sub, L))
        else:
            out[f"{prefix}.{key}"] = (L, *sub.shape)
    return out


@pytest.mark.parametrize("arch", registry.list_archs())
def test_logical_axes_and_shapes_equal_the_reference(arch, reference_axes):
    ref_tree, shapes, axes = reference_axes[arch]
    model = build_model(registry.get_config(arch), device="meta")
    assert model.logical_axes() == ref_tree
    port_shapes = {name: tuple(p.shape)
                   for name, p in model.named_parameters(recurse=False)}
    for name, layers in model.named_children():
        port_shapes.update(_stacked_shapes(name, layers[0].tree(),
                                           len(layers)))
    flat = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(ref_build(ref_registry.get_config(arch)).init,
                       jax.random.PRNGKey(0)))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(s.shape)
            for path, s in flat}
    assert port_shapes == want


def test_spec_for_reads_only_the_mesh_shape():
    """A port Mesh (a 256-slot CPU grid) and a stand-in of its shape give
    the same specs; the fallbacks drop the outermost axis first."""
    grid = Mesh(np.full((16, 16), "cpu", dtype=object), ("data", "model"))
    table = sharding.PARAM_RULES_LARGE
    for shape, ax in [((128256, 4096), ("vocab", "embed")),
                      ((4096, 1000), ("embed", "mlp")),
                      ((24, 8), ("embed", "qdim"))]:
        fb1, fb2 = [], []
        assert sharding.spec_for(shape, ax, table, grid, fb1) == \
            sharding.spec_for(shape, ax, table, stand_in(grid.shape), fb2)
        assert fb1 == fb2
    fb = []
    big = stand_in(MESHES["2x16x16"])
    assert sharding.spec_for((64, 16), ("embed", "mlp"), table, big, fb) \
        == (("pod", "data"), "model")
    assert sharding.spec_for((16, 8), ("embed", "mlp"), table, big, fb) \
        == ("data", None)
    assert fb == ["embed:16 !% pod", "mlp:8 !% model"]


def test_constraint_is_the_identity_under_rules():
    x = torch.randn(2, 3)
    rules = make_rules(registry.get_config("llama3-8b"),
                       stand_in(MESHES["16x16"]))
    assert sharding.current_rules() is None
    with sharding.use_rules(rules):
        assert sharding.current_rules() is rules
        assert sharding.constraint(x, "batch", "embed") is x
    assert sharding.current_rules() is None


# ------------------------------------------------- placements on the meshes
PRODUCTION = {"single": False, "multi": True}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_param_shard_shapes(arch: str, multi_pod: bool) -> dict:
    """The reference's ``tree_param_shardings`` on an abstract production
    mesh: {leaf path: NamedSharding.shard_shape(leaf shape)}."""
    from jax.sharding import AbstractMesh

    from repro.configs.shapes import abstract_params
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    cfg = ref_registry.get_config(arch)
    rules = ref_mesh.make_rules(cfg, AbstractMesh(shape, names))
    params = abstract_params(cfg)
    shardings = ref_sharding.tree_param_shardings(
        params, ref_build(cfg).logical_axes(), rules)
    placed = _flat(shardings)
    return {k: placed[k].shard_shape(p.shape)
            for k, p in _flat(params).items()}


@pytest.mark.parametrize("arch", registry.list_archs())
@pytest.mark.parametrize("mesh", PRODUCTION)
def test_tree_param_shardings_equal_the_reference(arch, mesh):
    """Every param leaf's shard shape on the production mesh equals the
    reference's ``NamedSharding.shard_shape``."""
    from repro_torch.configs.shapes import abstract_params
    from repro_torch.launch.mesh import make_production_mesh
    cfg = registry.get_config(arch)
    rules = make_rules(cfg, make_production_mesh(
        multi_pod=PRODUCTION[mesh]))
    params = abstract_params(cfg)
    placed = sharding.tree_param_shardings(
        params, build_model(cfg, device="meta").logical_axes(), rules)
    got = {k: pl.shard_shape(_flat(params)[k].shape)
           for k, pl in _flat(placed).items()}
    assert all(isinstance(pl, sharding.Placement) and pl.mesh is rules.mesh
               for pl in _flat(placed).values())
    assert got == _ref_param_shard_shapes(arch, PRODUCTION[mesh])


def test_production_mesh_is_meta_at_the_reference_shapes():
    from repro_torch.launch.mesh import make_production_mesh
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert single.axis_names == ("data", "model")
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512
    assert {str(d) for d in multi.devices.reshape(-1)} == {"meta"}
    assert not torch.cuda.is_initialized()


def test_sharding_for_without_rules_is_none():
    assert sharding.current_rules() is None
    assert sharding.sharding_for((8, 4), ("batch", None)) is None
    assert sharding.sharding_for((8, 4), ("embed", "mlp"), params=True) \
        is None


def test_sharding_for_equals_the_reference_spec():
    """With rules (passed or active), ``sharding_for`` holds the
    reference's ``PartitionSpec`` on the mesh, and its shard shape the
    reference's."""
    from jax.sharding import AbstractMesh
    cfg = registry.get_config("llama3-8b")
    m = stand_in(MESHES["2x16x16"])
    rules = make_rules(cfg, m)
    ref_rules = ref_mesh.make_rules(
        ref_registry.get_config("llama3-8b"),
        AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    for shape, ax, params in [((256, 4096), ("batch", None), False),
                              ((1, 1), ("batch", None), False),
                              ((4096, 14336), ("embed", "mlp"), True),
                              ((128256, 4096), ("vocab", "embed"), True)]:
        got = sharding.sharding_for(shape, ax, params=params, rules=rules)
        want = ref_sharding.sharding_for(shape, ax, params=params,
                                         rules=ref_rules)
        assert got.spec == tuple(want.spec) and got.mesh is m
        assert got.shard_shape(shape) == want.shard_shape(shape)
        with sharding.use_rules(rules):
            assert sharding.sharding_for(shape, ax, params=params) == got


def test_placement_shard_shape_refuses_what_does_not_divide():
    m = stand_in(MESHES["2x16x16"])
    pl = sharding.Placement(m, (("pod", "data"), "model"))
    assert pl.shard_shape((64, 32)) == (2, 2)
    assert pl.shard_shape((64, 32, 5)) == (2, 2, 5)
    assert sharding.Placement(m, ()).shard_shape(()) == ()
    with pytest.raises(ValueError):
        pl.shard_shape((48, 32))
