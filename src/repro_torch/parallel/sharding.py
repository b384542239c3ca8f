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


def constraint(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding constraint by logical names: the identity
    here, since a tensor of the port lives whole on one device."""
    del logical
    return x
