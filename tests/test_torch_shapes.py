"""The port's dry-run shapes (``repro_torch.configs.shapes``) against the
reference's ``repro.configs.shapes``, for every arch of the registry and
each of the four shapes: ``applicable`` and its reason, the
``input_specs`` shapes and dtypes, the ``abstract_params`` leaf names,
shapes and dtypes (the reference's ``jax.eval_shape(model.init, ...)``),
the ``abstract_cache`` shapes and dtypes, ``param_count``,
``active_param_count`` and ``model_flops``, all exactly.  The port's
stand-ins are ``meta`` tensors: they allocate nothing."""

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import registry, shapes  # noqa: E402

ARCHS = registry.list_archs()
SHAPE_NAMES = list(shapes.SHAPES)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _sig(leaf):
    """(shape, dtype name) of a jax ShapeDtypeStruct or a torch tensor."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    return tuple(leaf.shape), str(leaf.dtype)


def _sigs(tree):
    return {k: _sig(v) for k, v in _flat(tree).items()}


@pytest.fixture(scope="module")
def reference():
    """Every reference quantity the tests compare, computed once."""
    out = {}
    for arch in ARCHS:
        cfg = ref_registry.get_config(arch)
        out[arch] = {
            "params": _sigs(ref_shapes.abstract_params(cfg)),
            "param_count": ref_shapes.param_count(cfg),
            "active": ref_shapes.active_param_count(cfg),
            "applicable": {s: ref_shapes.applicable(cfg, s)
                           for s in SHAPE_NAMES},
            "specs": {s: _sigs(ref_shapes.input_specs(cfg, s))
                      for s in SHAPE_NAMES},
            "cache": {s: _sigs(ref_shapes.abstract_cache(cfg, s))
                      for s in SHAPE_NAMES},
            "flops": {s: ref_shapes.model_flops(cfg, s)
                      for s in SHAPE_NAMES},
        }
    return out


def test_shape_table_equals_the_reference():
    assert shapes.SHAPES.keys() == ref_shapes.SHAPES.keys()
    for name, sh in shapes.SHAPES.items():
        assert vars(sh) == vars(ref_shapes.SHAPES[name])
    assert shapes.SUBQUADRATIC_FAMILIES == ref_shapes.SUBQUADRATIC_FAMILIES
    assert configs.SHAPES is shapes.SHAPES
    assert configs.applicable is shapes.applicable


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_input_specs_equal_the_reference(arch, reference):
    cfg = registry.get_config(arch)
    for s in SHAPE_NAMES:
        assert shapes.applicable(cfg, s) == reference[arch]["applicable"][s]
        specs = shapes.input_specs(cfg, s)
        assert list(specs) == list(reference[arch]["specs"][s]), s
        assert _sigs(specs) == reference[arch]["specs"][s], s


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference(arch, reference):
    got = _sigs(shapes.abstract_params(registry.get_config(arch)))
    assert got == reference[arch]["params"]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_equals_the_reference(arch, reference):
    cfg = registry.get_config(arch)
    for s in SHAPE_NAMES:
        assert _sigs(shapes.abstract_cache(cfg, s)) == \
            reference[arch]["cache"][s], s


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_equal_the_reference(arch, reference):
    cfg = registry.get_config(arch)
    assert shapes.param_count(cfg) == reference[arch]["param_count"]
    assert shapes.active_param_count(cfg) == reference[arch]["active"]
    for s in SHAPE_NAMES:
        assert shapes.model_flops(cfg, s) == reference[arch]["flops"][s], s


@pytest.mark.parametrize("arch", ["arctic-480b", "whisper-medium",
                                  "hymba-1.5b"])
def test_stand_ins_allocate_nothing(arch):
    """Every stand-in lives on ``meta``: arctic's params alone would be
    957 GB in bf16, its long-context cache more."""
    cfg = registry.get_config(arch)
    leaves = list(_flat(shapes.abstract_params(cfg)).values())
    for s in SHAPE_NAMES:
        leaves += _flat(shapes.input_specs(cfg, s)).values()
        leaves += _flat(shapes.abstract_cache(cfg, s)).values()
    assert leaves and all(t.is_meta for t in leaves)
    if arch == "arctic-480b":
        assert sum(t.numel() * t.element_size() for t in leaves) > 9e11
