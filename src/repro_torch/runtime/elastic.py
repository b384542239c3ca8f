"""Elastic grid rule: the largest usable (pod, data, model) grid for the
devices that are healthy now.

Port of ``repro/runtime/elastic.py``: :func:`choose_mesh` picks the
grid, :func:`build_mesh` lays devices on it as a
:class:`~repro_torch.core.distributed.Mesh`.  The serving tier reuses the
grid rule one level up: ``repro_torch.launch.autoscale.default_max_workers``
caps its elastic worker pool at ``choose_mesh(cpu_count,
max_model=1).n_devices`` — one serving worker per data-parallel slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.distributed import Mesh, default_devices

__all__ = ["choose_mesh", "build_mesh", "MeshPlan"]


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


def build_mesh(plan: MeshPlan, devices=None) -> Mesh:
    """The first ``plan.n_devices`` of ``devices`` (default: every visible
    card; ``RuntimeError`` without one) on ``plan``'s grid.  A device may
    repeat: ``["cpu"] * 8`` is an 8-slot CPU grid."""
    devices = list(devices) if devices is not None else default_devices()
    if len(devices) < plan.n_devices:
        raise AssertionError("not enough healthy devices")
    arr = np.empty(plan.n_devices, dtype=object)
    arr[:] = devices[:plan.n_devices]
    return Mesh(arr.reshape(plan.shape), plan.axis_names)
