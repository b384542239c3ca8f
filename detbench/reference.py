"""The plain reference: Radic's determinant and its gradient by the
definition, in plain PyTorch, in any floating dtype.

For an m×n matrix A (m <= n), det(A) = Σ_J (-1)^(r + s(J)) det(A[:, J])
over the C(n, m) column sets J = j1 < ... < jm (1-indexed), with
r = 1 + ... + m and s(J) = j1 + ... + jm; m > n gives 0.  Every minor is
eliminated on its own by Gaussian elimination with partial pivoting,
and the gradient adds each minor's cofactors, det(M)·M⁻ᵀ (Gauss-Jordan),
into the columns of J.  The column sets and signs are made here from
(m, n) alone.  Imports torch only: nothing of the program under test.

The benchmark runs it in float64 on the matrices it generated, after
the measured window, in blocks of minors so that it fits; the control
runs the same code in bfloat16.
"""

from __future__ import annotations

import torch

# Elements of a block of minors (m·m each, times the stack): bounds the
# memory of one elimination to a few GiB in float64.
BLOCK_ELEMS = 1 << 26


def combinations(n: int, m: int, device=None) -> torch.Tensor:
    """All m-subsets of 0..n-1 in lexicographic order → (C(n, m), m)."""
    c = torch.arange(n - m + 1, device=device)[:, None]
    for level in range(1, m):
        last = c[:, -1]
        counts = (n - m + level) - last          # next value in last+1 ..
        rows = torch.repeat_interleave(c, counts, dim=0)
        starts = torch.cumsum(counts, 0) - counts
        offs = torch.arange(rows.shape[0], device=device) \
            - torch.repeat_interleave(starts, counts)
        nxt = torch.repeat_interleave(last + 1, counts) + offs
        c = torch.cat([rows, nxt[:, None]], 1)
    return c


def signs(cols: torch.Tensor, m: int, dtype) -> torch.Tensor:
    """(-1)^(r + s(J)) for 0-indexed column sets ``cols (N, m)``."""
    e = m * (m + 1) // 2 + m + cols.sum(1)
    return (1 - 2 * (e % 2)).to(dtype)


def _pivot(M: torch.Tensor, k: int, ar: torch.Tensor, det: torch.Tensor
           ) -> torch.Tensor:
    """Swap the row of the largest |entry| of column k (rows k..) into
    row k; returns det with the swaps' sign."""
    p = M[:, k:, k].abs().argmax(1) + k
    rk, rp = M[ar, k].clone(), M[ar, p].clone()
    M[ar, k] = rp
    M[ar, p] = rk
    return torch.where(p != k, -det, det)


def det_ge(M: torch.Tensor) -> torch.Tensor:
    """Determinants of a stack ``(N, m, m)`` by Gaussian elimination with
    partial pivoting, in ``M.dtype``."""
    M = M.clone()
    N, m, _ = M.shape
    ar = torch.arange(N, device=M.device)
    det = torch.ones(N, dtype=M.dtype, device=M.device)
    for k in range(m):
        det = _pivot(M, k, ar, det)
        piv = M[:, k, k].clone()
        det = det * piv
        if k + 1 < m:   # a zero pivot (det 0 already) divides by 1
            f = M[:, k + 1:, k] / torch.where(piv == 0, 1, piv)[:, None]
            M[:, k + 1:, k + 1:] -= f[:, :, None] * M[:, k, None, k + 1:]
    return det


def det_inv(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Determinants and inverses of a stack ``(N, m, m)`` by Gauss-Jordan
    elimination with partial pivoting, in ``M.dtype``."""
    N, m, _ = M.shape
    eye = torch.eye(m, dtype=M.dtype, device=M.device).expand(N, m, m)
    G = torch.cat([M, eye], 2)
    ar = torch.arange(N, device=M.device)
    det = torch.ones(N, dtype=M.dtype, device=M.device)
    for k in range(m):
        det = _pivot(G, k, ar, det)
        piv = G[:, k, k].clone()
        det = det * piv
        G[:, k] /= torch.where(piv == 0, 1, piv)[:, None]
        f = G[:, :, k].clone()
        f[:, k] = 0
        G -= f[:, :, None] * G[:, k, None, :]
    return det, G[:, :, m:]


def _blocks(As: torch.Tensor, cols: torch.Tensor):
    """Minors of the stack ``As (k, m, n)`` by blocks of column sets:
    (block of cols, minors (k, Nb, m, m))."""
    k, m, _ = As.shape
    nb = max(1, BLOCK_ELEMS // (k * m * m))
    for i in range(0, cols.shape[0], nb):
        c = cols[i:i + nb]
        yield c, As[:, :, c].permute(0, 2, 1, 3)   # (k, Nb, m rows, m)


def radic_values(As: torch.Tensor, dtype=torch.float64
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Radic determinants of a shape-uniform stack ``As (k, m, n)`` → (k,),
    every step in ``dtype``; and the root-sum-square of each one's
    signed minors, sqrt(Σ_J det(A[:, J])²), the scale of the rounding
    error of a sum of those terms."""
    k, m, n = As.shape
    As = As.to(dtype)
    total = torch.zeros(k, dtype=dtype, device=As.device)
    squares = torch.zeros(k, dtype=dtype, device=As.device)
    if m > n:
        return total, squares
    for c, minors in _blocks(As, combinations(n, m, As.device)):
        d = det_ge(minors.reshape(-1, m, m)).reshape(k, -1)
        total = total + (d * signs(c, m, dtype)).sum(1)
        squares = squares + (d * d).sum(1)
    return total, squares.sqrt()


def radic_grads(As: torch.Tensor, cts: torch.Tensor,
                dtype=torch.float64) -> torch.Tensor:
    """ct · d det / d A for a stack ``As (k, m, n)`` and cotangents
    ``cts (k,)`` → (k, m, n), every step in ``dtype``."""
    k, m, n = As.shape
    As = As.to(dtype)
    grads = torch.zeros((k, m, n), dtype=dtype, device=As.device)
    if m > n:
        return grads
    cts = cts.to(device=As.device, dtype=dtype)
    for c, minors in _blocks(As, combinations(n, m, As.device)):
        nb = c.shape[0]
        det, inv = det_inv(minors.reshape(-1, m, m))
        # cofactors det·M⁻ᵀ, each scaled by its sign and its cotangent
        scale = (det.reshape(k, nb) * signs(c, m, dtype)) * cts[:, None]
        cof = inv.reshape(k, nb, m, m).transpose(2, 3) \
            * scale[:, :, None, None]
        for p in range(m):   # minor column p is A's column c[:, p]
            grads.index_add_(2, c[:, p], cof[:, :, :, p].permute(0, 2, 1))
    return grads
