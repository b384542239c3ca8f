"""Pascal-triangle tables (paper Table 1) used by combinatorial addition.

Copy of ``repro/core/pascal.py`` (numpy only): the port keeps its own
copy so that it never imports the JAX package.

The paper indexes its table as ``A(j, i) = C(i + j, j)`` for rows
``j = 0..m-1`` and columns ``i = 1..n-m`` (the last column holds the place
weights ``C(n-1, m-1), ..., C(n-m, 0)``).  The production code uses the
equivalent canonical table ``T[a, b] = C(a, b)`` because every entry the
walk touches is ``C(n - v, m - 1 - i)`` for some candidate value ``v`` and
position ``i`` — a direct lookup in ``T``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "binom_table",
    "paper_table",
    "comb",
    "INT32_MAX",
    "INT64_MAX",
]

INT32_MAX = 2**31 - 1
INT64_MAX = 2**63 - 1


def comb(n: int, k: int) -> int:
    """Exact C(n, k) with Python bigints (0 outside the triangle)."""
    if k < 0 or n < 0 or k > n:
        return 0
    return math.comb(n, k)


def binom_table(n: int, m: int, dtype=np.int64) -> np.ndarray:
    """Canonical table ``T[a, b] = C(a, b)``, shape ``(n+1, m+1)``.

    Entries with ``b > a`` are 0 (used as a natural guard by the
    vectorized unranking walk).  Raises if any entry overflows ``dtype`` —
    callers that need bigger ranges must use the host bigint path
    (:func:`repro_torch.core.unrank.unrank_py`).
    """
    limit = INT32_MAX if np.dtype(dtype) == np.int32 else INT64_MAX
    # True table peak is the mid column of the last row: C(n, min(m, n//2)).
    # (C(n, m) alone underestimates it when m > n/2 — e.g. (40, 30) stores
    # C(40, 20) ≈ 1.4e11 even though C(40, 30) = C(40, 10) fits int32 —
    # and a wrapping int32 cast would silently corrupt those entries.)
    peak = comb(n, min(m, n // 2))
    if peak > limit:
        raise OverflowError(
            f"binom_table({n},{m}) peak entry C({n},{min(m, n // 2)}) = "
            f"{peak} exceeds {np.dtype(dtype).name}; use the grain mode "
            "(host bigint grain starts + on-device successors)."
        )
    T = np.zeros((n + 1, m + 1), dtype=np.int64)
    T[:, 0] = 1
    for a in range(1, n + 1):
        hi = min(a, m)
        T[a, 1 : hi + 1] = T[a - 1, 0:hi] + T[a - 1, 1 : hi + 1]
    return T.astype(dtype)


def paper_table(n: int, m: int) -> np.ndarray:
    """Literal Table 1 of the paper: ``A[j, i-1] = C(i + j, j)``.

    Shape ``(m, n - m)`` — rows ``j = 0..m-1``, columns ``i = 1..n-m``.
    Kept for fidelity tests; production uses :func:`binom_table`.
    """
    if n <= m:
        return np.zeros((m, 0), dtype=np.int64)
    A = np.zeros((m, n - m), dtype=np.int64)
    for j in range(m):
        for i in range(1, n - m + 1):
            A[j, i - 1] = comb(i + j, j)
    return A
