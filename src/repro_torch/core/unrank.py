"""Combinatorial addition — rank-addressable enumeration of ascending sequences.

Port of ``repro/core/unrank.py``.  The paper's core contribution (Section
4, Theorem 2): map an arbitrary rank ``q`` in ``[0, C(n, m))`` to the
``q``-th ``m``-subset of ``{1..n}`` in dictionary (lexicographic) order,
independently of all other ranks, in ``O(m (n-m))`` time.

* :func:`unrank_py` / :func:`rank_py` / :func:`successor_py` — exact host
  Python (bigints, no width limit), copied from the reference.
* :func:`unrank_torch` / :func:`rank_torch` / :func:`successor_torch` —
  batched torch versions of the reference's ``*_jnp`` functions, on int64
  ranks.  The unranking walk is *lane-uniform in the candidate value*
  ``v``: exactly ``n`` steps, per-lane state is only (position ``i``,
  remaining ``q``).  The CUDA kernel (``kernels/csrc/common.cuh``) runs
  the same walk, one rank per thread.

Conventions: combinations are **1-indexed** ascending tuples, matching the
paper (``B_0 = [1, 2, .., m]``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .pascal import binom_table, comb

__all__ = [
    "first_member",
    "last_member",
    "unrank_py",
    "rank_py",
    "successor_py",
    "unrank_torch",
    "rank_torch",
    "successor_torch",
]


# --------------------------------------------------------------------------
# Host (exact, bigint) reference path.
# --------------------------------------------------------------------------

def first_member(m: int) -> tuple[int, ...]:
    return tuple(range(1, m + 1))


def last_member(n: int, m: int) -> tuple[int, ...]:
    return tuple(range(n - m + 1, n + 1))


def unrank_py(q: int, n: int, m: int) -> tuple[int, ...]:
    """Exact unranking with Python ints (no overflow)."""
    if not 0 <= q < comb(n, m):
        raise ValueError(f"rank {q} outside [0, C({n},{m}))")
    out = []
    v = 1
    for i in range(m):  # position i gets the smallest feasible value
        while True:
            cnt = comb(n - v, m - 1 - i)
            if q < cnt:
                out.append(v)
                v += 1
                break
            q -= cnt
            v += 1
    return tuple(out)


def rank_py(combo: Sequence[int], n: int, m: int) -> int:
    """Inverse of :func:`unrank_py` (dictionary-order rank, exact)."""
    combo = tuple(combo)
    if len(combo) != m or any(c < 1 or c > n for c in combo):
        raise ValueError(f"not an m-subset of 1..{n}: {combo}")
    if any(a >= b for a, b in zip(combo, combo[1:])):
        raise ValueError(f"not ascending: {combo}")
    q = 0
    prev = 0
    for i, c in enumerate(combo):
        # hockey-stick: sum_{v=prev+1}^{c-1} C(n-v, m-1-i)
        q += comb(n - prev, m - i) - comb(n - c + 1, m - i)
        prev = c
    return q


def successor_py(combo: Sequence[int], n: int) -> tuple[int, ...] | None:
    """Next combination in dictionary order (None past the last member).

    This is the paper's per-grain enumeration step (second listing of
    Fig. 1): find the rightmost place below its cap, bump it, reset the
    suffix to a consecutive run.
    """
    b = list(combo)
    m = len(b)
    for i in range(m - 1, -1, -1):
        if b[i] < n - m + i + 1:
            b[i] += 1
            for j in range(i + 1, m):
                b[j] = b[j - 1] + 1
            return tuple(b)
    return None


# --------------------------------------------------------------------------
# Vectorized torch path (int64 ranks).
# --------------------------------------------------------------------------

def _table(n: int, m: int, table: torch.Tensor | None,
           device: torch.device) -> torch.Tensor:
    if table is None:
        # binom_table's own peak check bounds this build
        return torch.as_tensor(binom_table(n, m, dtype=np.int64),
                               device=device)
    return table.to(device=device, dtype=torch.int64)


def unrank_torch(qs: torch.Tensor, n: int, m: int,
                 table: torch.Tensor | None = None) -> torch.Tensor:
    """Batched unranking: ``qs (B,) int -> combos (B, m) int64`` (1-indexed).

    The candidate value ``v`` advances ``1..n`` uniformly across lanes (a
    loop of ``n`` steps); lane ``b`` places ``v`` at position ``i_b`` iff
    ``q_b < C(n - v, m - 1 - i_b)``.  ``table`` is a precomputed
    :func:`binom_table` (any integer dtype; the walk runs in int64).
    """
    q = torch.as_tensor(qs).to(torch.int64)
    table = _table(n, m, table, q.device)
    B = q.shape[0]
    pos = torch.zeros(B, dtype=torch.int64, device=q.device)
    combo = torch.zeros((B, m), dtype=torch.int64, device=q.device)
    cols = torch.arange(m, dtype=torch.int64, device=q.device)
    for s in range(n):
        v = s + 1  # candidate value, uniform across lanes
        row = table[n - v]  # (m+1,) counts C(n-v, *)
        cnt = row[(m - 1 - pos).clamp(0, m)]
        active = pos < m
        place = active & (q < cnt)
        combo = torch.where(place[:, None] & (cols[None, :] == pos[:, None]),
                            v, combo)
        q = torch.where(active & ~place, q - cnt, q)
        pos = pos + place.to(torch.int64)
    return combo


def rank_torch(combos: torch.Tensor, n: int, m: int,
               table: torch.Tensor | None = None) -> torch.Tensor:
    """Batched rank: ``combos (B, m) -> (B,)`` int64."""
    combos = torch.as_tensor(combos).to(torch.int64)
    table = _table(n, m, table, combos.device)
    prevs = torch.cat([torch.zeros_like(combos[:, :1]), combos[:, :-1]],
                      dim=1)
    ks = m - torch.arange(m, dtype=torch.int64, device=combos.device)
    # contribution_i = C(n - prev_i, m - i) - C(n - c_i + 1, m - i)
    t_hi = table[n - prevs, ks[None, :]]
    t_lo = table[n - combos + 1, ks[None, :]]
    return (t_hi - t_lo).sum(dim=1)


def successor_torch(combos: torch.Tensor, n: int) -> torch.Tensor:
    """Batched dictionary-order successor, fully vectorized (no loop).

    ``combos (B, m) -> (B, m)``.  The last member maps to itself (callers
    mask by grain length).
    """
    combos = torch.as_tensor(combos)
    B, m = combos.shape
    idx = torch.arange(m, dtype=combos.dtype, device=combos.device)
    caps = n - m + idx + 1  # max value allowed at each place
    can = combos < caps[None, :]
    any_can = can.any(dim=1)
    # last True index per lane (torch.argmax returns the first maximum)
    i_star = (m - 1) - torch.argmax(can.flip(1).to(torch.int32), dim=1)
    base = torch.gather(combos, 1, i_star[:, None].to(torch.int64))
    bumped = base + 1 + (idx[None, :] - i_star[:, None])
    nxt = torch.where(idx[None, :] < i_star[:, None], combos, bumped)
    return torch.where(any_can[:, None], nxt, combos).to(combos.dtype)
