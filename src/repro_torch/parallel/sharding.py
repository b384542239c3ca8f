"""Logical→physical sharding rule engine.

Port of ``repro/parallel/sharding.py``.  Models annotate tensors with
*logical* axis names ("batch", "mlp", …).  A :class:`ShardingRules` maps
logical names to the axes of a :class:`~repro_torch.core.distributed.Mesh`,
with a **divisibility fallback**: if a dim doesn't divide over the mapped
axes, the engine drops axes (outermost first) until it does, and records
the fallback so a log can show it (never silent).

Two rule tables per run: one for parameters (TP + FSDP placement) and one
for activations (batch/seq placement).  :func:`spec_for` returns the
entries of the reference's ``PartitionSpec`` as a tuple (``None``, an
axis name, or a tuple of names per dim) and reads only ``mesh.shape``.
A :class:`Placement` (a mesh and such a tuple) stands where the
reference holds a ``NamedSharding``: :func:`sharding_for` and
:func:`tree_param_shardings` return them, and ``shard_shape`` gives the
shape one device of the mesh would hold.  Nothing is placed by them: the
dry run reads the shard shapes.

:func:`constraint` is the identity, in a ``use_rules`` context too: the
port's mesh is a grid of devices driven by one controller and has no
sharded tensor type, so there is nothing to constrain (the reference
calls ``with_sharding_constraint`` there).  The port's models do not
call it: the annotations come back with a sharded tensor type.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

__all__ = ["ShardingRules", "use_rules", "constraint", "spec_for",
           "Placement", "sharding_for", "tree_param_shardings",
           "ACT_RULES_SMALL", "ACT_RULES_LARGE", "PARAM_RULES_SMALL",
           "PARAM_RULES_LARGE", "current_rules"]

# ---------------------------------------------------------------------------
# Default rule tables.  "small" = replicate params across pods (DP over pod),
# "large" = FSDP params over (pod, data) as well (405B-class).
# ---------------------------------------------------------------------------

ACT_RULES_SMALL: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,              # "model" under sequence/context parallelism
    "kv_seq": "model",        # decode KV cache length (context parallel)
    "embed": None,
    "qdim": "model",
    "kvdim": None,
    "heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "cap": None,
    "inner": "model",         # SSM d_inner
    "ssm_heads": "model",
    "state": None,
    "chunk": None,
    "frames": None,
}
ACT_RULES_LARGE = dict(ACT_RULES_SMALL)

PARAM_RULES_SMALL: dict[str, Any] = {
    "layers": None,
    "embed": "data",          # FSDP dim within a pod
    "qdim": "model",
    "kvdim": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "inner": "model",
    "state": None,
    "conv": None,
    "ssm_heads": "model",
    "head_dim": None,
    "heads": "model",
    "misc": None,
}
PARAM_RULES_LARGE = dict(PARAM_RULES_SMALL, embed=("pod", "data"))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                 # a Mesh, or anything with a .shape mapping
    act: Mapping[str, Any]
    params: Mapping[str, Any]
    log_fallbacks: bool = False

    def axis_size(self, name: str) -> int:
        return self.mesh.shape.get(name, 1)


_ACTIVE: contextvars.ContextVar[ShardingRules | None] = \
    contextvars.ContextVar("repro_torch_sharding_rules", default=None)


def current_rules() -> ShardingRules | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    tok = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(tok)


def _normalize(phys) -> tuple[str, ...]:
    if phys is None:
        return ()
    if isinstance(phys, str):
        return (phys,)
    return tuple(phys)


def _fit_axes(dim: int, axes: tuple[str, ...], mesh,
              fallbacks: list[str] | None, logical: str) -> tuple[str, ...]:
    """Drop leading physical axes until the dim divides evenly."""
    # only keep axes that exist in this mesh
    cand = [a for a in axes if a in mesh.shape]
    while cand:
        prod = math.prod(mesh.shape[a] for a in cand)
        if dim % prod == 0:
            return tuple(cand)
        dropped = cand.pop(0)  # drop the outermost (pod first) for locality
        if fallbacks is not None:
            fallbacks.append(f"{logical}:{dim} !% {dropped}")
    return ()


def spec_for(shape: Sequence[int], logical: Sequence[str | None],
             table: Mapping[str, Any], mesh,
             fallbacks: list[str] | None = None) -> tuple:
    """The placement of a tensor given its logical axis names: one entry a
    dim, as the reference's ``PartitionSpec`` holds them."""
    assert len(shape) == len(logical), (shape, logical)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, logical):
        if name is None or name not in table:
            parts.append(None)
            continue
        axes = _fit_axes(dim, _normalize(table[name]), mesh, fallbacks, name)
        axes = tuple(a for a in axes if a not in used)
        # re-check divisibility after removing already-used axes
        if axes and dim % math.prod(mesh.shape[a] for a in axes) != 0:
            axes = ()
        used.update(axes)
        parts.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor's placement on a mesh: the port's ``NamedSharding``.
    ``spec`` holds one entry a dim, as :func:`spec_for` returns it."""
    mesh: Any
    spec: tuple

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """The shape one device holds: each dim divided by the product of
        the sizes of the axes it is mapped to (``ValueError`` where that
        does not divide it)."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} for a {len(global_shape)}-d "
                             "shape")
        spec = self.spec + (None,) * (len(global_shape) - len(self.spec))
        out = []
        for dim, axes in zip(global_shape, spec):
            n = math.prod(self.mesh.shape[a] for a in _normalize(axes))
            if dim % n:
                raise ValueError(f"dim {dim} of {global_shape} does not "
                                 f"divide over {axes} ({n})")
            out.append(dim // n)
        return tuple(out)


def sharding_for(shape, logical, *, params: bool = False,
                 rules: ShardingRules | None = None) -> Placement | None:
    """The placement of a tensor by its logical axis names under
    ``rules`` (default: the active ones); ``None`` without rules."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return None
    table = rules.params if params else rules.act
    return Placement(rules.mesh, spec_for(shape, logical, table, rules.mesh))


def tree_param_shardings(param_tree, logical_tree,
                         rules: ShardingRules | None = None):
    """A tree of :class:`Placement` for params (or their meta stand-ins):
    ``param_tree``'s nesting of dicts, its leaves' logical axes read from
    the same place in ``logical_tree`` (whose tuples are leaves)."""
    rules = rules if rules is not None else current_rules()
    assert rules is not None, "tree_param_shardings needs active rules"

    def one(p, ax):
        if isinstance(p, dict):
            return {k: one(v, ax[k]) for k, v in p.items()}
        return Placement(rules.mesh,
                         spec_for(p.shape, ax, rules.params, rules.mesh))

    return one(param_tree, logical_tree)


def constraint(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding constraint by logical names: the identity
    here, since a tensor of the port lives whole on one device."""
    del logical
    return x
