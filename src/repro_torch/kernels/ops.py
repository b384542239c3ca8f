"""Public entry points of the Radic kernels: validation, Pascal table and
dispatch.

Port of ``repro/kernels/ops.py``, in the reference's order (ops.py:42-81):
``m > n`` returns zeros; then :func:`validate_rank_space` for the
``cuda`` backend (int32 ranks, ``m <= 16``); then a rank range past
``C(n, m)`` raises ``ValueError``; then the kernel wrapper runs.  The
wrappers launch the CUDA kernel for a CUDA tensor and run its plain
torch version for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import rank_table, validate_rank_space

from .radic_fused import radic_batched_partial_cuda, radic_partial_cuda

__all__ = ["radic_det_cuda", "radic_det_batched_cuda"]


def _rank_range(m: int, n: int, q_start: int, count: int | None) -> int:
    total = validate_rank_space(m, n, backend="cuda")
    if count is None:
        count = total - q_start
    if q_start + count > total:
        raise ValueError("rank range exceeds C(n, m)")
    return count


def _tensor(A) -> torch.Tensor:
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(A).__name__}")
    return A


def radic_det_cuda(A: torch.Tensor, q_start: int = 0,
                   count: int | None = None, *, tile: int = 256,
                   table: torch.Tensor | None = None) -> torch.Tensor:
    """Radic determinant (or a rank-range partial) of ``A (m, n)`` through
    the K2 entry.  ``tile`` is accepted for parity with the reference; the
    CUDA kernel's rank tile is fixed at 256.  ``table`` is the int32
    Pascal table, built here when not given (plans bind it once)."""
    A = _tensor(A)
    m, n = A.shape
    if m > n:
        return torch.zeros((), dtype=A.dtype, device=A.device)
    count = _rank_range(m, n, q_start, count)
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
    if table is None:
        table = rank_table(n, m, backend="cuda", device=As.device)
    return radic_batched_partial_cuda(As, table, q_start, count)
