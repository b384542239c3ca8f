"""The benchmark's yardstick: the least work of an answer and the least
time one H100 could take for it.

Frozen copies of ``chip_smoke.py``'s operation counts and peaks, with one
change: the forward's least work is the smaller of the prefix walk's count
and the per-minor count for every m, not only for m >= 17, so that a later
prefix walk at m <= 16 cannot read above 100 % of its roofline.  The work
of an answer is counted from the request's own (m, n), whatever bucket or
kernel served it.  Nothing here imports the program.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

# Peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet): float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def ge_flops(m: int) -> int:
    """Float operations of one signed minor eliminated alone: elimination
    (a division and m-1-k multiply-adds per row below pivot k), the
    diagonal product, the sign and the accumulation."""
    return sum(j * (1 + 2 * j) for j in range(1, m)) + (m - 1) + 2


def grad_flops(m: int) -> int:
    """Float operations of one (rank, matrix) pair of the backward
    (nonsingular branch): the LU, det(U)·U⁻¹ (products of the other
    pivots, then a back-substitution), the product with L⁻¹, the m²
    scaled cofactors and the m² adds of the scatter."""
    lu = sum(j * (1 + 2 * j) for j in range(1, m))
    pivots = m * (m - 1)
    back = sum(2 * (c - r) + 1 for c in range(m) for r in range(c))
    linv = m * m * (m - 1)
    return lu + pivots + back + linv + 2 + 2 * m * m


@lru_cache(maxsize=None)
def prefix_walk_flops(m: int, n: int) -> int:
    """Float operations over all C(n, m) ranks of one matrix with every
    elimination prefix done once: the step that eliminates a prefix's
    last column c from its L live rows takes a reciprocal, L - 1
    multipliers (a product and two multiply-adds each) and the pivots'
    product, and updates the L - 1 rows of each column after c that a
    combination can still take (a multiply-add each); a prefix of length
    k ending at c is one of C(c, k - 1); each leaf adds its product, two
    signs and the sum."""
    total = 4 * comb(n, m)
    for k in range(1, m):
        rows = m - k   # L - 1
        for c in range(k - 1, n - m + k):
            total += comb(c, k - 1) * (2 * rows * (n - 1 - c) + 5 * rows + 2)
    return total


@lru_cache(maxsize=None)
def value_flops(m: int, n: int) -> int:
    """Least float operations of one determinant: the prefix count where
    prefixes repeat, each minor alone where they do not."""
    if m > n:
        return 0
    return min(prefix_walk_flops(m, n), comb(n, m) * ge_flops(m))


@lru_cache(maxsize=None)
def gradient_flops(m: int, n: int) -> int:
    """Least float operations of one gradient: every minor's cofactors."""
    if m > n:
        return 0
    return comb(n, m) * grad_flops(m)


def answer_work(m: int, n: int, grad: bool) -> tuple[int, int]:
    """(float operations, bytes) of one answer: its matrix read once and
    its answer written once (and a gradient's cotangent read)."""
    if grad:
        return gradient_flops(m, n), F32 * (2 * m * n + 1)
    return value_flops(m, n), F32 * (m * n + 1)


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time on one H100, s: the larger of the operations over
    the float32 peak and the bytes over the memory rate, and which of
    the two bounds it."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
