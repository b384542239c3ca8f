"""The port's sharding rules (``repro_torch.parallel.sharding`` and
``launch/mesh.py``'s ``make_rules``) against the reference's: the rule
tables, and ``spec_for`` with its fallbacks for every param of every
arch's ``logical_axes()`` (full widths, from the reference's abstract
init), on stand-in meshes of shapes (16, 16) and (2, 16, 16), with the
small and the large param tables and each arch's own rules.  The port's
``logical_axes`` and param shapes equal the reference's for every arch;
``constraint`` is the identity (the port has no sharded
tensor type)."""

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
