"""Pure numpy/itertools oracles for the kernels of this package.

Copy of ``repro/kernels/ref.py`` on the port's own ``core``.  Each
kernel's semantics are *defined* by the function here with the same
name; tests assert allclose against these.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.oracle import radic_det_oracle  # noqa: F401 (re-export)
from repro_torch.core.pascal import comb
from repro_torch.core.unrank import unrank_py

__all__ = ["unrank_ref", "minor_det_ref", "radic_partial_ref"]


def unrank_ref(qs: np.ndarray, n: int, m: int) -> np.ndarray:
    """Batched unranking oracle: (B,) ranks -> (B, m) 1-indexed combos."""
    return np.array([unrank_py(int(q), n, m) for q in np.asarray(qs)],
                    dtype=np.int32).reshape(len(qs), m)


def minor_det_ref(mats: np.ndarray) -> np.ndarray:
    """Batched determinant oracle: (B, m, m) -> (B,) float."""
    return np.linalg.det(np.asarray(mats, dtype=np.float64)).astype(
        np.asarray(mats).dtype)


def radic_partial_ref(A: np.ndarray, q_start: int, count: int) -> float:
    """Signed minor sum over ranks [q_start, q_start + count) — float64."""
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    if q_start + count > comb(n, m):
        raise ValueError("rank range exceeds C(n, m)")
    r = m * (m + 1) // 2
    total = 0.0
    for q in range(q_start, q_start + count):
        combo = unrank_py(q, n, m)
        s = sum(combo)
        sign = -1.0 if (r + s) % 2 else 1.0
        cols = [c - 1 for c in combo]
        total += sign * np.linalg.det(A[:, cols])
    return total
