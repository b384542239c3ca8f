"""Gradient compression for cross-pod data parallelism.

Port of ``repro/parallel/compress.py``.  At 512+ chips the DP all-reduce
of 100B-class gradients dominates the inter-pod link; two standard
mitigations, both pytree transforms so they compose with any optimizer:

* int8 quantized all-reduce — per-tensor absmax scaling, ~4× fewer bytes
  on the wire; the sum of int32-accumulated int8 values.
* top-k sparsification with error feedback (memory) — keeps the k largest
  entries per tensor, residual is fed back next step (1-bit Adam-style
  convergence behaviour).

The math is the reference's in float32, op for op (``torch.round``
rounds half to even, as ``jnp.round``), so a leaf agrees with the
reference's bit for bit on either device.  Every division is by a
tensor on the dividend's device (:func:`_div`): a CUDA kernel divides by a
Python scalar as a product with its reciprocal, which can be one bit off
the quotient.  The reference's :func:`psum_int8` runs inside
``shard_map`` with the replicas' axes bound; the port has no
``shard_map``, so over replicas it takes one gradient tree per position
of the mesh's ``axis_names``, each on its own device, and combines them
from one controller on the mesh's first device.  With no axes it is the
quantize round trip, as the reference's under plain ``jit``.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = ["quantize_int8", "dequantize_int8", "psum_int8",
           "topk_with_error_feedback", "init_error_feedback",
           "replica_devices"]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as a true float32 quotient on every device."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric absmax int8 quantization -> (q, scale)."""
    xf = x.to(torch.float32)
    scale = _div(xf.abs().max(), 127.0) + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _replica_axes(mesh, axis_names: Sequence[str]) -> list[str]:
    for a in axis_names:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not in the mesh's "
                             f"{mesh.axis_names}")
    return [a for a in mesh.axis_names if a in axis_names]


def replica_devices(mesh, axis_names: Sequence[str]) -> list[torch.device]:
    """The device of each replica: the positions of ``axis_names`` in the
    grid's row-major order, index 0 on the mesh's other axes."""
    axes = _replica_axes(mesh, axis_names)
    pos = [mesh.axis_names.index(a) for a in axes]
    out = []
    for coords in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        index = [0] * len(mesh.axis_names)
        for p, c in zip(pos, coords):
            index[p] = c
        out.append(mesh.devices[tuple(index)])
    return out


def _pmean_scales(scales: list[torch.Tensor], sizes: list[int],
                  axes: list[str], axis_names: Sequence[str]
                  ) -> torch.Tensor:
    """The reference's ``pmean`` loop over ``axis_names`` on the replicas'
    scales (float32, on one device; ``sizes`` the grid of ``axes``): each
    axis in turn replaces every scale by the mean along that axis, summed
    in index order.  Every replica ends with the same scale."""
    grid = torch.stack(scales).reshape(sizes)
    for a in axis_names:
        d = axes.index(a)
        acc = grid.select(d, 0)
        for i in range(1, sizes[d]):
            acc = acc + grid.select(d, i)
        grid = _div(acc, sizes[d]).unsqueeze(d).expand(sizes)
    return grid.reshape(-1)[0]


def psum_int8(grads, axis_names: Sequence[str] = (), *, mesh=None):
    """Quantized DP all-reduce: quantize → sum (int32) → dequantize (mean).

    With no ``axis_names``, ``grads`` is one tree and each leaf makes the
    quantize round trip.  Over replicas, ``grads`` is a list of trees, one
    per position of ``axis_names`` on ``mesh`` in the grid's row-major
    order (:func:`replica_devices`), each on its replica's device: every
    replica quantizes its leaves on its device; the int32 sums are added
    on the mesh's first device in replica order (exact); the scales are
    averaged one axis at a time in ``axis_names`` order, as the
    reference's ``pmean`` loop; each leaf comes back on the first device
    as ``acc · s / n`` in the gradient's dtype, ``n`` the replica count.
    """
    if not axis_names:
        return pytree.tree_map(
            lambda g: dequantize_int8(*quantize_int8(g), dtype=g.dtype),
            grads)
    if mesh is None:
        raise ValueError("psum_int8 over axes needs the mesh")
    axes = _replica_axes(mesh, axis_names)
    sizes = [mesh.shape[a] for a in axes]
    n = math.prod(sizes)
    devs = replica_devices(mesh, axis_names)
    if len(grads) != n:
        raise ValueError(f"{len(grads)} gradient trees for {n} replicas of "
                         f"{dict(zip(axes, sizes))}")
    first = mesh.first_device
    flat = [pytree.tree_flatten(g) for g in grads]
    spec = flat[0][1]
    for leaves, sp in flat:
        if sp != spec:
            raise ValueError("the replicas' gradient trees differ")
    out = []
    for i, g0 in enumerate(flat[0][0]):
        acc, scales = None, []
        for r, (leaves, _) in enumerate(flat):
            q, s = quantize_int8(leaves[i].to(devs[r]))
            q = q.to(first).to(torch.int32)
            acc = q if acc is None else acc + q
            scales.append(s.to(first))
        s = _pmean_scales(scales, sizes, axes, axis_names)
        out.append(_div(acc.to(torch.float32) * s, n).to(g0.dtype))
    return pytree.tree_unflatten(out, spec)


def init_error_feedback(grads):
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def topk_with_error_feedback(grads, memory, frac: float = 0.01):
    """Keep the top-``frac`` magnitude entries per tensor; the rest is
    accumulated into ``memory`` and re-added next step.

    Returns (sparse_grads, new_memory)."""
    def one(g, m):
        gf = g.to(torch.float32) + m
        flat = gf.abs().reshape(-1)
        k = max(1, int(frac * flat.numel()))
        thresh = torch.topk(flat, k).values[-1]
        keep = gf.abs() >= thresh
        sparse = torch.where(keep, gf, 0.0)
        return sparse.to(g.dtype), gf - sparse

    flat, spec = pytree.tree_flatten(grads)
    mem = pytree.tree_flatten(memory)[0]
    out = [one(g, m) for g, m in zip(flat, mem)]
    return (pytree.tree_unflatten([o[0] for o in out], spec),
            pytree.tree_unflatten([o[1] for o in out], spec))
