"""Mesh-distributed Radic determinant — the paper's granularity scheme.

Port of ``repro/core/distributed.py``.  Section 5 of the paper: with
``k`` processors, the rank space ``[0, C(n, m))`` is cut into ``k``
contiguous grains; each processor unranks its grain start once
(combinatorial addition) and then walks successors inside the grain.  Here
a "processor" is a position of a :class:`Mesh`, a grid of torch devices
driven by one controller (the reference's single-controller mesh); the
tree-sum of the PRAM CREW analysis becomes the combine step, the
counterpart of the reference's ``psum``: each shard's partial is copied to
the mesh's first device and the partials are added there one after
another, in shard order (C order over the rank axes).  No atomics and no
order that depends on timing, so a result is the same from run to run.

Two modes:

* ``"grains"`` (default) — grain starts are unranked on the **host with
  exact bigints** at plan time (no integer-width limit); each grid
  position walks its local grains in lock-step with
  :func:`~repro_torch.core.unrank.successor_torch`, masked by ``step <
  length``.  The walk is eager torch on every backend, as the reference's
  is jnp whatever its backend, and costs one Python step per lock-step:
  keep it to rank spaces whose grains are at most ~1,000 ranks long
  (``C(n, m) / (grid size · grains_per_device)``).
* ``"flat"`` — shard ``d`` evaluates the ranks ``[q0_d, q0_d + cnt_d)`` of
  :func:`plan_grains` over the grid: on the ``cuda`` backend by one launch
  of K2 (``kernels.radic_fused.radic_partial_cuda``) over that exact range,
  on ``torch`` by the eager chunk walk.

The batched makers split the batch into ``mesh.shape[batch_axis]``
contiguous pieces and the rank space over the remaining axes; each (piece,
rank range) pair runs on the grid position with those coordinates, through
K1 (``radic_batched_partial_cuda``) for values and K3
(``radic_batched_grad_partial_cuda``) for the cofactor-form gradient on
``cuda``, the eager walks of ``core/radic.py`` on ``torch``.  Grid
positions that differ only in axes outside ``axis_names`` compute the same
shard, which runs once, on the first of them.  A device may repeat in a
mesh (one card can host a (2, 4) grid): its shards then run one after
another on its current stream.

The ``make_*`` makers bind the plan-time half once per shape; the public
``radic_det*_distributed`` entries route through
:class:`repro_torch.core.engine.DetEngine`, so repeated calls on equal
meshes reuse the planned shards.
"""

from __future__ import annotations

import math
from types import MappingProxyType
from typing import Sequence

import numpy as np
import torch

from .engine import rank_table, validate_rank_space
from .radic import (_compute_dtype, _radic_det_batched_flat_impl,
                    _radic_det_batched_grad_flat, _radic_det_flat,
                    radic_det, radic_det_batched, resolve_device,
                    signed_minor_sum)
from .unrank import first_member, successor_torch, unrank_py

__all__ = ["Mesh", "radic_det_distributed", "radic_det_batched_distributed",
           "make_distributed_evaluator", "make_batched_distributed_evaluator",
           "make_batched_distributed_grad_evaluator", "plan_grains",
           "default_devices"]


class Mesh:
    """A grid of torch devices with named axes: the port's counterpart of
    ``jax.sharding.Mesh``, a frozen, hashable value.

    ``devices`` is an n-d numpy object array of ``torch.device``
    (read-only), ``axis_names`` one name per dimension, ``shape`` maps each
    name to its size (``mesh.shape["data"]``) and ``size`` counts the grid
    positions.  A device may repeat, which is how one card or one CPU
    hosts a (2, 4) grid.  Two meshes over equal devices and names compare
    and hash equal, so the engine plans them once."""

    __slots__ = ("_devices", "_names", "_key")

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in grid.reshape(-1)]
        names = tuple(str(a) for a in axis_names)
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if grid.ndim != len(names):
            raise ValueError(f"{grid.ndim}-d devices for axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        arr = arr.reshape(grid.shape)
        arr.flags.writeable = False
        self._devices = arr
        self._names = names
        self._key = (arr.shape, tuple(flat), names)

    @property
    def devices(self) -> np.ndarray:
        return self._devices

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self._names

    @property
    def shape(self):
        return MappingProxyType(dict(zip(self._names, self._devices.shape)))

    @property
    def size(self) -> int:
        return self._devices.size

    @property
    def first_device(self) -> torch.device:
        """Where a mesh plan takes its input and combines its shards."""
        return self._key[1][0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self._key[1]]})")


def default_devices() -> list[torch.device]:
    """Every visible CUDA device; ``RuntimeError`` without a card."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _default_mesh(device=None) -> Mesh:
    """The 1-d ``("workers",)`` grid over every visible card, or the one
    slot of ``device`` when it is given (``"cpu"`` for the CPU)."""
    devs = default_devices() if device is None else [resolve_device(device)]
    return Mesh(devs, ("workers",))


def plan_grains(total: int, num_grains: int):
    """Contiguous grain bounds: ``num_grains`` slices covering [0, total)."""
    bounds = [total * g // num_grains for g in range(num_grains + 1)]
    starts = bounds[:-1]
    lengths = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    return starts, lengths


# ---------------------------------------------------------------- the grid
def _axes(mesh: Mesh, axis_names) -> tuple[str, ...]:
    axes = tuple(axis_names if axis_names is not None else mesh.axis_names)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in {mesh.axis_names}")
    return axes


def _shard_grid(mesh: Mesh, batch_axis: str | None,
                rank_axes: tuple[str, ...]) -> list[list[torch.device]]:
    """The device of each distinct shard: row ``p`` (batch piece, one row
    without a batch axis), column ``d`` (rank shard, C order over
    ``rank_axes``), at the first grid position with those coordinates."""
    names = mesh.axis_names
    lead = (batch_axis,) if batch_axis is not None else ()
    order = [names.index(a) for a in (*lead, *rank_axes)]
    order += [i for i in range(len(names)) if i not in order]
    pieces = mesh.shape[batch_axis] if batch_axis is not None else 1
    shards = math.prod(mesh.shape[a] for a in rank_axes)
    grid = mesh.devices.transpose(order).reshape(pieces, shards, -1)
    return [list(row[:, 0]) for row in grid]


def _tables(n: int, m: int, backend: str, grid) -> dict:
    """The Pascal table on each distinct device of the grid."""
    devs = dict.fromkeys(d for row in grid for d in row)
    return {d: rank_table(n, m, backend=backend, device=d) for d in devs}


def _combine(parts: list[torch.Tensor], device: torch.device
             ) -> torch.Tensor:
    """The reference's ``psum``: each shard's partial copied to ``device``
    and added there in shard order."""
    acc = parts[0].to(device)
    for part in parts[1:]:
        acc = acc + part.to(device)
    return acc


def _shard_fn(backend: str, what: str, chunk: int):
    """``fn(X, table, q0, cnt, cts)``: one shard's partial over the ranks
    ``[q0, q0 + cnt)`` — a scalar (``what="scalar"``), ``(B,)``
    (``"batched"``) or the cofactor-form gradient ``(B, m, n)``
    (``"grad"``, pulling back ``cts (B,)``)."""
    if backend == "cuda":
        from repro_torch.kernels import ops  # lazy: kernels depend on core
        if what == "scalar":    # K2
            return lambda X, T, q0, cnt, cts: ops.radic_det_cuda(
                X, q0, cnt, table=T)
        if what == "batched":   # K1
            return lambda X, T, q0, cnt, cts: ops.radic_det_batched_cuda(
                X, q0, cnt, table=T)
        return lambda X, T, q0, cnt, cts: ops.radic_det_batched_grad_cuda(
            X, cts, q0, cnt, table=T)                           # K3
    if what == "scalar":
        return lambda X, T, q0, cnt, cts: _radic_det_flat(
            X, T, cnt, chunk, False, q_start=q0)
    if what == "batched":
        return lambda X, T, q0, cnt, cts: _radic_det_batched_flat_impl(
            X, T, cnt, chunk, q_start=q0)
    return lambda X, T, q0, cnt, cts: _radic_det_batched_grad_flat(
        X, cts, T, cnt, chunk, q_start=q0)


def _make_ranges(m: int, n: int, mesh: Mesh, batch_axis, rank_axes,
                 total: int, chunk: int, backend: str, what: str):
    """Bind the rank ranges, tables and shard function of a flat or
    batched evaluation → ``run(X, cts=None)``: every (piece, rank shard)
    pair on its device, the partials combined on the mesh's first device
    and the pieces concatenated in order."""
    grid = _shard_grid(mesh, batch_axis, rank_axes)
    starts_q, lengths = plan_grains(total, len(grid[0]))
    chunk = int(min(chunk, max(max(lengths), 1)))
    tables = _tables(n, m, backend, grid)
    fn = _shard_fn(backend, what, chunk)
    first = mesh.first_device

    def run(X: torch.Tensor, cts: torch.Tensor | None = None):
        size = X.shape[0] // len(grid)
        outs = []
        for p, row in enumerate(grid):
            blk = X if batch_axis is None else X[p * size:(p + 1) * size]
            ct = cts if cts is None or batch_axis is None \
                else cts[p * size:(p + 1) * size]
            outs.append(_combine(
                [fn(blk.to(dev), tables[dev], q0, cnt,
                    None if ct is None else ct.to(dev))
                 for dev, q0, cnt in zip(row, starts_q, lengths)], first))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return run


# ----------------------------------------------------------- plan-time makers
def make_distributed_evaluator(m: int, n: int, *, mesh: Mesh,
                               axis_names: Sequence[str] | None = None,
                               grains_per_device: int = 1,
                               mode: str = "grains", chunk: int = 1024,
                               backend: str = "cuda"):
    """Bind the host-side half of a mesh evaluation once for one (m, n).

    Grain planning (the host-bigint grain-start unranking — the expensive
    part for astronomical C(n, m)), the Pascal tables and the shard
    devices are fixed here; the returned ``evaluate(A: (m, n)) -> scalar``
    only runs the shards and combines them on the mesh's first device.
    The rank space is sharded over ``axis_names`` (default: every axis).
    m > n is normalized by the engine before this maker runs.  A grains
    evaluator carries its plan as ``grain_starts`` (bigint ranks),
    ``grain_lengths`` and ``start_combos`` (1-indexed tuples).
    """
    axes = _axes(mesh, axis_names)
    if mode not in ("grains", "flat"):
        raise ValueError(f"unknown mode {mode!r}")
    total = validate_rank_space(m, n, backend=backend,
                                mesh_grains=(mode == "grains"))
    first = mesh.first_device
    if mode == "flat":
        return _make_ranges(m, n, mesh, None, axes, total, chunk, backend,
                            "scalar")
    devs = _shard_grid(mesh, None, axes)[0]
    D = len(devs)
    G = D * grains_per_device
    if total < G:  # degenerate: fewer subsets than grains
        G = D      # keep one grain per device, some empty
    starts_q, lengths = plan_grains(total, G)
    combos = [unrank_py(q, n, m) if cnt > 0 else first_member(m)
              for q, cnt in zip(starts_q, lengths)]
    F = G // D
    shards = []
    for d, dev in enumerate(devs):
        local = slice(d * F, (d + 1) * F)
        shards.append((
            dev,
            torch.tensor(combos[local], dtype=torch.int64,
                         device=dev).reshape(F, m),
            torch.tensor(lengths[local], dtype=torch.int64, device=dev),
            max(lengths[local])))

    def evaluate(A: torch.Tensor) -> torch.Tensor:
        X = A.to(_compute_dtype(A.dtype))
        parts = []
        for dev, starts, lens, steps in shards:
            Xd = X.to(dev)
            acc = torch.zeros((), dtype=X.dtype, device=dev)
            combo = starts
            for step in range(steps):  # F grains in lock-step
                if step:
                    combo = successor_torch(combo, n)
                acc = acc + signed_minor_sum(Xd, combo, step < lens)
            parts.append(acc)
        return _combine(parts, first).to(A.dtype)

    evaluate.grain_starts = starts_q
    evaluate.grain_lengths = lengths
    evaluate.start_combos = combos
    return evaluate


def _batched_axes(mesh: Mesh, axis_names, batch_axis):
    axes = _axes(mesh, axis_names)
    if batch_axis is None:
        return axes
    if batch_axis not in axes:
        raise ValueError(f"batch_axis {batch_axis!r} not in {axes}")
    return tuple(a for a in axes if a != batch_axis)


def _check_batch(As: torch.Tensor, m: int, n: int, mesh: Mesh,
                 batch_axis) -> None:
    """The per-call checks of the batched makers (the reference's)."""
    if As.ndim != 3 or tuple(As.shape[1:]) != (m, n):
        raise ValueError(f"expected (B, {m}, {n}), got {tuple(As.shape)}")
    if batch_axis is not None and As.shape[0] % mesh.shape[batch_axis]:
        raise ValueError(
            f"batch {As.shape[0]} is not divisible by mesh axis "
            f"{batch_axis} size {mesh.shape[batch_axis]}")


def make_batched_distributed_evaluator(
        m: int, n: int, *, mesh: Mesh,
        axis_names: Sequence[str] | None = None,
        batch_axis: str | None = None, chunk: int = 1024,
        backend: str = "cuda"):
    """Plan-time half of the batched mesh evaluation for one (m, n).

    Returns ``evaluate(As: (B, m, n)) -> (B,)``.  With ``batch_axis`` the
    batch is split over that axis (``B`` must be divisible by its size —
    checked per call) and the rank space over the remaining axes;
    otherwise the whole batch goes to every rank shard and the rank space
    is cut over every axis.
    """
    rank_axes = _batched_axes(mesh, axis_names, batch_axis)
    total = validate_rank_space(m, n, backend=backend)
    run = _make_ranges(m, n, mesh, batch_axis, rank_axes, total, chunk,
                       backend, "batched")

    def evaluate(As: torch.Tensor) -> torch.Tensor:
        _check_batch(As, m, n, mesh, batch_axis)
        return run(As)

    return evaluate


def make_batched_distributed_grad_evaluator(
        m: int, n: int, *, mesh: Mesh,
        axis_names: Sequence[str] | None = None,
        batch_axis: str | None = None, chunk: int = 1024,
        backend: str = "cuda"):
    """Cofactor-form VJP of :func:`make_batched_distributed_evaluator`.

    Returns ``grad(As: (B, m, n), cts: (B,)) -> (B, m, n)``.  Sharding
    mirrors the forward exactly — batch (and cotangents) over
    ``batch_axis``, rank space over the remaining axes — and each rank
    shard pulls the cotangents back through its own range, so the combine
    step adds per-shard gradient partials (DESIGN_GRAD.md).
    """
    rank_axes = _batched_axes(mesh, axis_names, batch_axis)
    total = validate_rank_space(m, n, backend=backend)
    run = _make_ranges(m, n, mesh, batch_axis, rank_axes, total, chunk,
                       backend, "grad")

    def grad(As: torch.Tensor, cts) -> torch.Tensor:
        _check_batch(As, m, n, mesh, batch_axis)
        cts = torch.as_tensor(cts, device=As.device).to(As.dtype).reshape(
            As.shape[0])
        return run(As, cts)

    return grad


# ------------------------------------------------------- engine-routed entry
def radic_det_distributed(A, *, mesh: Mesh | None = None,
                          axis_names: Sequence[str] | None = None,
                          grains_per_device: int = 1, mode: str = "grains",
                          chunk: int = 1024, backend: str = "cuda",
                          device=None) -> torch.Tensor:
    """Radic determinant distributed over a device mesh.

    ``A (m, n)`` goes to every shard; the rank space is sharded.  Returns
    a 0-d tensor on the mesh's first device, differentiable as
    :func:`~repro_torch.core.radic.radic_det` is.  The default mesh is
    every visible card, or the one slot of ``device`` when it is given.
    Routed through the default engine, so the host-side grain planning is
    cached per (shape, mesh, mode) and paid once.
    """
    mesh = mesh if mesh is not None else _default_mesh(device)
    return radic_det(A, chunk=chunk, backend=backend, mesh=mesh,
                     axis_names=axis_names, mode=mode,
                     grains_per_device=grains_per_device)


def radic_det_batched_distributed(As, *, mesh: Mesh | None = None,
                                  axis_names: Sequence[str] | None = None,
                                  batch_axis: str | None = None,
                                  chunk: int = 1024, backend: str = "cuda",
                                  device=None) -> torch.Tensor:
    """Batched Radic determinants sharded rank space × batch over a mesh.

    ``As (B, m, n)`` — one shared (m, n) shape, so the whole batch walks a
    single rank space with one Pascal table a device.  Returns ``(B,)`` on
    the mesh's first device.  Routed through the default engine (one
    planned evaluator per shape × mesh); the default mesh is as in
    :func:`radic_det_distributed`.
    """
    mesh = mesh if mesh is not None else _default_mesh(device)
    return radic_det_batched(As, chunk=chunk, backend=backend, mesh=mesh,
                             axis_names=axis_names, batch_axis=batch_axis)
