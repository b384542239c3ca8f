"""Independent numpy/itertools oracles for the Radic determinant.

Everything here is deliberately *simple and slow* — pure enumeration with
``itertools.combinations`` (which emits dictionary order by construction)
and ``np.linalg.det`` in float64, plus an exact integer Bareiss path for
small integer matrices.  Copy of ``repro/core/oracle.py``; every path of
the port (the eager torch backend, the CUDA kernels) is tested against
these.
"""

from __future__ import annotations

import itertools
from fractions import Fraction

import numpy as np

__all__ = [
    "combinations_lex",
    "radic_det_oracle",
    "radic_det_exact",
    "det_exact",
]


def combinations_lex(n: int, m: int) -> list[tuple[int, ...]]:
    """All m-subsets of {1..n} in dictionary order (paper Table 2)."""
    return [tuple(c) for c in itertools.combinations(range(1, n + 1), m)]


def radic_det_oracle(A: np.ndarray) -> float:
    """Radic determinant by brute enumeration, float64."""
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    if m > n:
        return 0.0  # paper Definition 3
    if m == 0:
        return 1.0
    r = m * (m + 1) // 2
    total = 0.0
    for combo in itertools.combinations(range(n), m):
        s = sum(combo) + m  # 1-indexed column sum
        sign = -1.0 if (r + s) % 2 else 1.0
        total += sign * np.linalg.det(A[:, combo])
    return total


def det_exact(M: list[list[Fraction]]) -> Fraction:
    """Exact determinant via fraction-free Bareiss elimination."""
    M = [row[:] for row in M]
    k = len(M)
    if k == 0:
        return Fraction(1)
    sign = Fraction(1)
    prev = Fraction(1)
    for i in range(k - 1):
        if M[i][i] == 0:
            for r in range(i + 1, k):
                if M[r][i] != 0:
                    M[i], M[r] = M[r], M[i]
                    sign = -sign
                    break
            else:
                return Fraction(0)
        for r in range(i + 1, k):
            for c in range(i + 1, k):
                M[r][c] = (M[r][c] * M[i][i] - M[r][i] * M[i][c]) / prev
            M[r][i] = Fraction(0)
        prev = M[i][i]
    return sign * M[k - 1][k - 1]


def radic_det_exact(A) -> Fraction:
    """Exact Radic determinant for (small) rational matrices."""
    rows = [[Fraction(x) for x in row] for row in np.asarray(A).tolist()]
    m = len(rows)
    n = len(rows[0]) if m else 0
    if m > n:
        return Fraction(0)
    r = m * (m + 1) // 2
    total = Fraction(0)
    for combo in itertools.combinations(range(n), m):
        s = sum(combo) + m
        sign = Fraction(-1 if (r + s) % 2 else 1)
        minor = [[rows[a][j] for j in combo] for a in range(m)]
        total += sign * det_exact(minor)
    return total
