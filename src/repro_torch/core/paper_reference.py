"""Literal host-Python port of the paper's Section-4 procedure.

Figure 1's pseudo-code is OCR-garbled (see DESIGN.md §1); this module
implements the procedure *as defined by the prose + Example 1*:

  1. Build Table 1 (``A(j, i) = C(i+j, j)``).
  2. Starting from the First Member and column ``col = n - m``: pick the
     largest row ``j`` whose entry ``C(col + j, j)`` does not exceed ``q``;
     walk left in that row accumulating entries while the running sum stays
     ``<= q`` (``p`` = number of entries consumed);
  3. add ``p`` to place ``m - j`` and cascade the suffix into a consecutive
     run; ``q -= sum``; continue from column ``col - p``; stop at ``q = 0``.

Validated against the paper's own artifacts in tests/test_paper_fidelity.py:
Example 1 (q=49, n=8, m=5 -> [2,5,6,7,8]) and the full Table 2 (all 56
subsets), plus exhaustive equality with the canonical combinatorial-number-
system unranking (:func:`repro_torch.core.unrank.unrank_py`) on small (n, m).
Copy of ``repro/core/paper_reference.py``.
"""

from __future__ import annotations

from typing import Sequence

from .pascal import comb

__all__ = ["combinatorial_addition", "grain_sequence"]


def combinatorial_addition(q: int, n: int, m: int) -> tuple[int, ...]:
    """Add ``q`` to the First Member — the paper's Fig. 1 (first listing)."""
    if not 0 <= q < comb(n, m):
        raise ValueError(f"rank {q} outside [0, C({n},{m}))")
    B = list(range(1, m + 1))  # First Member
    col = n - m                # current (1-indexed) table column
    while q > 0:
        # largest row j with table entry C(col + j, j) <= q
        j = None
        for jj in range(m - 1, -1, -1):
            if comb(col + jj, jj) <= q:
                j = jj
                break
        if j is None:  # cannot happen for valid q (C(col, 0) = 1 <= q)
            raise AssertionError("combinatorial addition stalled")
        # walk left in row j while the running sum stays <= q
        s = 0
        p = 0
        i = col
        while i >= 1 and s + comb(i + j, j) <= q:
            s += comb(i + j, j)
            p += 1
            i -= 1
        # add p to place (m - j), cascade suffix into a consecutive run
        B[m - j - 1] += p
        for h in range(m - j, m):
            B[h] = B[h - 1] + 1
        q -= s
        col -= p
    return tuple(B)


def grain_sequence(start: Sequence[int], count: int, n: int
                   ) -> list[tuple[int, ...]]:
    """The paper's per-processor grain walk (Fig. 1, second listing).

    From ``start``, emit ``count`` consecutive dictionary-order sequences
    (successor chain) — each processor covers ``C(n,m)/k`` of these.
    """
    b = list(start)
    m = len(b)
    out = [tuple(b)]
    for _ in range(count - 1):
        # rightmost place below its cap
        i = m - 1
        while i >= 0 and b[i] >= n - m + i + 1:
            i -= 1
        if i < 0:
            break  # ran past the last member
        b[i] += 1
        for h in range(i + 1, m):
            b[h] = b[h - 1] + 1
        out.append(tuple(b))
    return out
