"""Public entry points of the Radic kernels: validation, Pascal table and
dispatch.

Port of ``repro/kernels/ops.py``, in the reference's order (ops.py:42-143):
``m > n`` returns zeros; then :func:`validate_rank_space` for the
``cuda`` backend (int32 ranks); then a rank range past ``C(n, m)`` raises
``ValueError``; then ``m = 0`` is answered as the oracle and the
reference's jnp backend answer it (the empty minor's determinant, 1, for
the one rank of ``C(n, 0)``; a zero-row gradient), before any table,
launch or build (the reference's pallas backend raises
``ZeroDivisionError`` there); then the int32 Pascal table is built,
whose peak entry raises ``OverflowError`` past int32 (at (33, 34), say);
then (gradients) the cotangents are reshaped to ``(B,)`` in the input
dtype; then the kernel wrapper runs.  No entry bounds m, as in the
reference: the wrappers take m ≤ 16 to the register kernels and larger m
to the warp kernels.  ``unrank`` checks only the int32 width and
``minor_det`` nothing.  The wrappers launch the CUDA kernel for a CUDA
tensor and run its plain torch version for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import rank_table, validate_rank_space
from repro_torch.core.pascal import INT32_MAX, comb

from .minor_det import minor_det_cuda
from .radic_fused import (radic_batched_grad_partial_cuda,
                          radic_batched_partial_bygrid_cuda,
                          radic_batched_partial_cuda, radic_grad_partial_cuda,
                          radic_partial_cuda)
from .unrank_kernel import unrank_cuda

__all__ = ["minor_det", "unrank", "radic_det_cuda", "radic_det_batched_cuda",
           "radic_det_batched_cuda_bygrid", "radic_det_grad_cuda",
           "radic_det_batched_grad_cuda"]


def _rank_range(m: int, n: int, q_start: int, count: int | None) -> int:
    total = validate_rank_space(m, n, backend="cuda")
    if count is None:
        count = total - q_start
    if q_start + count > total:
        raise ValueError("rank range exceeds C(n, m)")
    return count


def _empty_minor(As: torch.Tensor, count: int, shape: tuple) -> torch.Tensor:
    """m = 0: the one rank of C(n, 0) is the empty column set, whose
    signed minor is 1, so a rank range of ``count`` (0 or 1) ranks sums
    to ``count``; no kernel takes m = 0, so nothing is launched."""
    return torch.full(shape, float(count), dtype=As.dtype, device=As.device)


def _tensor(A) -> torch.Tensor:
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(A).__name__}")
    return A


def minor_det(mats: torch.Tensor, *, tile: int = 128) -> torch.Tensor:
    """Batched determinant of ``(B, m, m)`` minors through the K6 entry
    (``tile`` matrices per block at m ≤ 16), for every m."""
    mats = _tensor(mats)
    return minor_det_cuda(mats, block=tile)


def unrank(qs: torch.Tensor, n: int, m: int, *,
           tile: int = 256) -> torch.Tensor:
    """Batched rank → 1-indexed combination ``(B, m)`` int32 through the
    K5 entry.  The kernel's int32 rank arithmetic is a hard limit, checked
    here as in the reference; m has no bound."""
    qs = _tensor(qs)
    total = comb(n, m)
    if m <= n and total > INT32_MAX:
        raise OverflowError(
            f"C({n},{m}) = {total} exceeds int32 (the CUDA kernel "
            "computes ranks in int32); use the torch backend.")
    table = rank_table(n, m, backend="cuda", device=qs.device)
    return unrank_cuda(qs, n, m, table, block=tile)


def radic_det_cuda(A: torch.Tensor, q_start: int = 0,
                   count: int | None = None, *, tile: int = 256,
                   table: torch.Tensor | None = None) -> torch.Tensor:
    """Radic determinant (or a rank-range partial) of ``A (m, n)`` through
    the K2 entry.  ``tile`` is accepted for parity with the reference; the
    CUDA kernel's rank tile is fixed (256 threads × 8 ranks).  ``table``
    is the int32 Pascal table, built here when not given (plans bind it
    once)."""
    A = _tensor(A)
    m, n = A.shape
    if m > n:
        return torch.zeros((), dtype=A.dtype, device=A.device)
    count = _rank_range(m, n, q_start, count)
    if m == 0:
        return _empty_minor(A, count, ())
    if table is None:
        table = rank_table(n, m, backend="cuda", device=A.device)
    return radic_partial_cuda(A, table, q_start, count)


def radic_det_batched_cuda(As: torch.Tensor, q_start: int = 0,
                           count: int | None = None, *, tile: int = 256,
                           table: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Batched Radic determinants (or rank-range partials) of a
    shape-uniform stack ``As (B, m, n)`` through the K1 entry → ``(B,)``.
    The rank tile is unranked once and shared by the whole batch; a
    matrix's result does not depend on the batch it is in."""
    As = _tensor(As)
    B, m, n = As.shape
    if m > n:
        return torch.zeros((B,), dtype=As.dtype, device=As.device)
    count = _rank_range(m, n, q_start, count)
    if m == 0:
        return _empty_minor(As, count, (B,))
    if table is None:
        table = rank_table(n, m, backend="cuda", device=As.device)
    return radic_batched_partial_cuda(As, table, q_start, count)


def radic_det_batched_cuda_bygrid(As: torch.Tensor, q_start: int = 0,
                                  count: int | None = None, *,
                                  table: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """The batched entry on the by-grid kernel (K4), behind the same
    guards: equal to :func:`radic_det_batched_cuda` bit for bit."""
    As = _tensor(As)
    B, m, n = As.shape
    if m > n:
        return torch.zeros((B,), dtype=As.dtype, device=As.device)
    count = _rank_range(m, n, q_start, count)
    if m == 0:
        return _empty_minor(As, count, (B,))
    if table is None:
        table = rank_table(n, m, backend="cuda", device=As.device)
    return radic_batched_partial_bygrid_cuda(As, table, q_start, count)


def radic_det_batched_grad_cuda(As: torch.Tensor, cts, q_start: int = 0,
                                count: int | None = None, *,
                                table: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Cofactor-form VJP of :func:`radic_det_batched_cuda`: pull the
    per-matrix cotangents ``cts (B,)`` back through the same rank walk
    through the K3 entry → ``(B, m, n)`` (DESIGN_GRAD.md)."""
    As = _tensor(As)
    B, m, n = As.shape
    if m > n:
        return torch.zeros_like(As)
    count = _rank_range(m, n, q_start, count)
    if m == 0:  # no entry to differentiate
        return torch.zeros_like(As)
    if table is None:
        table = rank_table(n, m, backend="cuda", device=As.device)
    cts = torch.as_tensor(cts, device=As.device).to(As.dtype).reshape(B)
    return radic_batched_grad_partial_cuda(As, cts, table, q_start, count)


def radic_det_grad_cuda(A: torch.Tensor, ct, q_start: int = 0,
                        count: int | None = None, *,
                        table: torch.Tensor | None = None) -> torch.Tensor:
    """Scalar-matrix VJP: ``A (m, n)``, scalar ``ct`` → ``(m, n)`` through
    the B = 1 entry of K3 — the same guards, the same walk."""
    A = _tensor(A)
    m, n = A.shape
    if m > n:
        return torch.zeros_like(A)
    count = _rank_range(m, n, q_start, count)
    if m == 0:  # no entry to differentiate
        return torch.zeros_like(A)
    if table is None:
        table = rank_table(n, m, backend="cuda", device=A.device)
    ct = torch.as_tensor(ct, device=A.device).to(A.dtype).reshape(())
    return radic_grad_partial_cuda(A, ct, table, q_start, count)
