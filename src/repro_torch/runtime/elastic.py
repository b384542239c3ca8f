"""Elastic grid rule: the largest usable (pod, data, model) grid for the
devices that are healthy now.

Port of the framework-free part of ``repro/runtime/elastic.py``
(:class:`MeshPlan`, :func:`choose_mesh`), which
``repro_torch.launch.autoscale.default_max_workers`` uses one level up:
the serving tier caps its elastic worker pool at
``choose_mesh(cpu_count, max_model=1).n_devices`` — one serving worker per
data-parallel slot.  Building a device mesh from a plan (the reference's
``build_mesh``) belongs to the mesh module of the port, which is not
ported yet.
"""

from __future__ import annotations

import dataclasses

__all__ = ["choose_mesh", "MeshPlan"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    n_devices: int


def _largest_pow2_leq(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def choose_mesh(n_devices: int, *, max_model: int = 16,
                want_pods: int = 1) -> MeshPlan:
    """Largest usable (pod, data, model) grid for ``n_devices``.

    Uses the largest power-of-two device count (lost nodes rarely leave a
    perfect grid); model axis = min(max_model, what fits); pods only if
    cleanly divisible.
    """
    usable = _largest_pow2_leq(max(1, n_devices))
    model = min(max_model, usable)
    rest = usable // model
    if want_pods > 1 and rest % want_pods == 0 and rest // want_pods >= 1:
        return MeshPlan((want_pods, rest // want_pods, model),
                        ("pod", "data", "model"), usable)
    return MeshPlan((rest, model), ("data", "model"), usable)
