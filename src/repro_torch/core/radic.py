"""Radic determinant of an m×n matrix (paper Definition 3) — eager torch path.

Port of ``repro/core/radic.py``.  ``det(A) = Σ_q
(−1)^(r + s_q) · det(A[:, B_q])`` over all ``C(n, m)`` column subsets
``B_q`` in dictionary order, where ``r = m(m+1)/2`` and ``s_q`` is the
(1-indexed) column sum of ``B_q``.

This is the ``"torch"`` backend, the twin of the reference's ``jnp``
backend: the rank space is streamed in fixed-size chunks, each chunk is
unranked independently, its transposed minors are gathered and fed to
``torch.linalg.det``, and the signed terms are accumulated.  The chunk
walk is a plain Python loop (the reference's ``fori_loop``).  It runs on
whatever device its input lies on.

The backward pass is the reference's cofactor-form VJP (DESIGN_GRAD.md):
each chunk unranks again exactly as the forward did and pulls the
cotangent back through that chunk's minor sum, so memory stays O(chunk)
and no autograd graph lives across chunks.  The pullback of one minor is
its cofactor matrix, computed in closed form (:func:`cofactors`), not by
autograd through ``torch.linalg.det``: that backward returns 0 instead of
the cofactors for an exactly singular minor of rank m−1 (a zero column,
or exact duplicate columns), where the Radic gradient is not 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .unrank import unrank_torch

__all__ = ["radic_det", "radic_det_batched", "make_batched_evaluator",
           "aot_compile_batched", "signed_minor_sum",
           "signed_minor_sum_batched", "signed_minor_pullback_batched",
           "cofactors", "radic_sign", "resolve_device"]


def radic_sign(combos: torch.Tensor, m: int) -> torch.Tensor:
    """(−1)^(r+s) for a batch of 1-indexed combinations ``(B, m)``."""
    r = m * (m + 1) // 2
    parity = (combos.sum(dim=1) + r) & 1
    return (1 - 2 * parity).to(torch.float32)


def signed_minor_sum(A: torch.Tensor, combos: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Σ sign(B_q)·det(A[:, B_q]) for a batch of combinations.

    ``A (m, n)``, ``combos (B, m)`` 1-indexed.  Uses the transposed-minor
    trick: ``det(A[:, J]) == det(A.T[J, :])`` so the gather is a single
    row-take.
    """
    m = A.shape[0]
    minors = A.T[combos - 1]                     # (B, m, m) transposed minors
    dets = torch.linalg.det(minors)
    terms = radic_sign(combos, m).to(dets.dtype) * dets
    if valid is not None:
        terms = torch.where(valid, terms, 0)
    return terms.sum()


def signed_minor_sum_batched(As: torch.Tensor, combos: torch.Tensor,
                             valid: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Batched-matrix form of :func:`signed_minor_sum`.

    ``As (B, m, n)``, ``combos (C, m)`` 1-indexed — the *same* rank chunk
    is applied to every matrix in the batch (one shared unranking, one
    shared sign vector).  Returns per-matrix partials ``(B,)``.
    """
    m = As.shape[1]
    minors = As.transpose(1, 2)[:, combos - 1]   # (B, C, m, m)
    dets = torch.linalg.det(minors)              # (B, C)
    terms = radic_sign(combos, m).to(dets.dtype)[None, :] * dets
    if valid is not None:
        terms = torch.where(valid[None, :], terms, 0)
    return terms.sum(dim=1)


_EXPLICIT_BATCH = 1 << 22   # elements per step of the explicit cofactors


def _explicit_cofactors(M: torch.Tensor) -> torch.Tensor:
    """cof[b, r, j] = (−1)^(r+j)·det(M[b] without row r and column j)
    for every matrix of ``M (k, m, m)``, m ≥ 2 — right at any rank."""
    k, m, _ = M.shape
    keep = torch.tensor([[i for i in range(m) if i != d] for d in range(m)],
                        dtype=torch.int64, device=M.device)     # (m, m-1)
    signs = 1 - 2 * ((torch.arange(m, device=M.device)[:, None]
                      + torch.arange(m, device=M.device)[None, :]) & 1)
    out = torch.empty_like(M)
    step = max(1, _EXPLICIT_BATCH // (m * m * (m - 1) * (m - 1)))
    for s in range(0, k, step):
        blk = M[s:s + step]
        # sub[b, r, j] = blk[b][keep[r]][:, keep[j]]
        sub = blk[:, keep[:, None, :, None], keep[None, :, None, :]]
        out[s:s + step] = torch.linalg.det(sub) * signs.to(M.dtype)
    return out


def cofactors(M: torch.Tensor) -> torch.Tensor:
    """The cofactor matrix of each matrix of ``M (..., m, m)``:
    ``cof[..., r, j] = ∂det(M)/∂M[..., r, j] = det(M)·(M⁻¹)[j, r]``.

    Nonsingular matrices take ``det·M⁻ᵀ`` from one LU factorisation; a
    matrix with an exactly zero pivot takes its m² (m−1)×(m−1)
    determinants, which is right at any rank (0, up to rounding, below
    rank m−1) — the same split as the CUDA kernel,
    ``csrc/radic_grad.cu``.  Never NaN for a finite input."""
    m = M.shape[-1]
    if m == 1:
        return torch.ones_like(M)
    batch = M.shape[:-2]
    flat = M.reshape(-1, m, m)
    LU, piv, _ = torch.linalg.lu_factor_ex(flat)
    diag = LU.diagonal(dim1=-2, dim2=-1)
    swaps = (piv != torch.arange(1, m + 1, dtype=piv.dtype,
                                 device=piv.device)).sum(-1)
    det = diag.prod(-1) * (1 - 2 * (swaps & 1)).to(flat.dtype)
    eye = torch.eye(m, dtype=flat.dtype, device=flat.device).expand_as(flat)
    inv = torch.linalg.lu_solve(LU, piv, eye)
    cof = det[:, None, None] * inv.mT
    singular = (diag == 0).any(-1)
    if bool(singular.any()):
        cof[singular] = _explicit_cofactors(flat[singular])
    return cof.reshape(*batch, m, m)


def _column_sums(vals: torch.Tensor, cols: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``out[..., c] = Σ vals[..., k]`` over ``cols[k] == c``, for ``vals
    (..., K)`` and ``cols (K,)`` in [0, n) → ``(..., n)``.

    A scatter-add without atomics: the entries are sorted stably by
    column, and each column's run is summed by a segmented Hillis–Steele
    scan of elementwise adds.  The order of the adds depends on ``cols``
    alone — the same on every device and for any leading shape, so a
    matrix's sums do not depend on its batch or its slot."""
    cols, order = torch.sort(cols, stable=True)
    x = vals[..., order]
    step = 1
    while step < cols.numel():
        same = cols[step:] == cols[:-step]     # same run, `step` apart
        x = torch.cat([x[..., :step],
                       x[..., step:] + torch.where(same, x[..., :-step], 0)],
                      dim=-1)
        step *= 2
    last = torch.ones_like(cols, dtype=torch.bool)
    last[:-1] = cols[1:] != cols[:-1]          # each run's last entry
    out = vals.new_zeros(*vals.shape[:-1], n)
    out[..., cols[last]] = x[..., last]
    return out


def signed_minor_pullback_batched(As: torch.Tensor, cts: torch.Tensor,
                                  combos: torch.Tensor,
                                  valid: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """VJP of :func:`signed_minor_sum_batched` at ``As (B, m, n)`` for
    cotangents ``cts (B,)`` → ``(B, m, n)``: each valid rank q adds
    ``cts[b]·sign(B_q)·cof(A_b[:, B_q])[:, j]`` into column ``B_q[j]``,
    in a fixed order (:func:`_column_sums`), so the result is
    bit-identical from run to run and across batch slots."""
    B, m, n = As.shape
    minors = As.transpose(1, 2)[:, combos - 1].transpose(-2, -1)
    w = cts.to(As.dtype)[:, None] \
        * radic_sign(combos, m).to(As.dtype)[None, :]            # (B, C)
    if valid is not None:
        w = torch.where(valid[None, :], w, 0)
    # (B, C, m rows, m positions) → (B, m rows, C·m columns)
    contrib = (w[:, :, None, None] * cofactors(minors)).permute(0, 2, 1, 3)
    return _column_sums(contrib.reshape(B, m, -1),
                        (combos - 1).reshape(-1), n)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """``torch.linalg.det`` takes float32/float64; narrower floats are
    computed in float32 and cast back by the caller."""
    return dtype if dtype in (torch.float32, torch.float64) \
        else torch.float32


def _radic_det_flat(A: torch.Tensor, table: torch.Tensor, total: int,
                    chunk: int, kahan: bool) -> torch.Tensor:
    m, n = A.shape
    X = A.to(_compute_dtype(A.dtype))
    num_chunks = -(-total // chunk)
    idx = torch.arange(chunk, dtype=torch.int64, device=A.device)
    acc = torch.zeros((), dtype=X.dtype, device=A.device)
    comp = torch.zeros_like(acc)
    for c in range(num_chunks):
        qs = c * chunk + idx
        valid = qs < total
        combos = unrank_torch(torch.where(valid, qs, 0), n, m, table)
        part = signed_minor_sum(X, combos, valid)
        if kahan:
            y = part - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        else:
            acc = acc + part
    return acc.to(A.dtype)


def _radic_det_batched_flat_impl(As: torch.Tensor, table: torch.Tensor,
                                 total: int, chunk: int) -> torch.Tensor:
    B, m, n = As.shape
    X = As.to(_compute_dtype(As.dtype))
    num_chunks = -(-total // chunk)
    idx = torch.arange(chunk, dtype=torch.int64, device=As.device)
    acc = torch.zeros((B,), dtype=X.dtype, device=As.device)
    for c in range(num_chunks):
        qs = c * chunk + idx
        valid = qs < total
        combos = unrank_torch(torch.where(valid, qs, 0), n, m, table)
        acc = acc + signed_minor_sum_batched(X, combos, valid)
    return acc.to(As.dtype)


def _radic_det_batched_grad_flat(As: torch.Tensor, cts, table: torch.Tensor,
                                 total: int, chunk: int) -> torch.Tensor:
    """Batched cofactor VJP: ``As (B, m, n)``, ``cts (B,)`` → ``(B, m, n)``.
    One shared unranking per chunk pulls back all B cotangents, and every
    chunk's pullback is added to the running gradient: the forward's walk
    replayed, O(chunk) memory.  The backward never compensates (the
    Kahan terms of a scalar forward are arithmetic identities)."""
    B, m, n = As.shape
    X = As.detach().to(_compute_dtype(As.dtype))
    cts = torch.as_tensor(cts, device=As.device).to(X.dtype).reshape(B)
    num_chunks = -(-total // chunk)
    idx = torch.arange(chunk, dtype=torch.int64, device=As.device)
    g = torch.zeros_like(X)
    for c in range(num_chunks):
        qs = c * chunk + idx
        valid = qs < total
        combos = unrank_torch(torch.where(valid, qs, 0), n, m, table)
        g = g + signed_minor_pullback_batched(X, cts, combos, valid)
    return g.to(As.dtype)


def _radic_det_grad_flat(A: torch.Tensor, ct, table: torch.Tensor,
                         total: int, chunk: int) -> torch.Tensor:
    """Scalar cofactor VJP: ``A (m, n)``, scalar ``ct`` → ``(m, n)``."""
    return _radic_det_batched_grad_flat(A[None], torch.as_tensor(ct).reshape(1),
                                        table, total, chunk)[0]


def resolve_device(device) -> torch.device:
    """The device a plan or queue runs on: ``"cuda"`` unless the caller
    asks for another.  Without a card, ``"cuda"`` raises — nothing
    carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the CPU")
    return dev


def _entry_device(A, device) -> torch.device:
    """A tensor computes on its own device; host data goes to ``device``,
    which defaults to the card."""
    if isinstance(A, torch.Tensor):
        return A.device
    return resolve_device(device)


def _as_tensor(A, device: torch.device) -> torch.Tensor:
    if isinstance(A, torch.Tensor):
        return A
    return torch.as_tensor(np.asarray(A), device=device)


def radic_det(A, *, chunk: int = 2048, kahan: bool = False,
              backend: str = "cuda", device=None) -> torch.Tensor:
    """Radic determinant (paper Definition 3) of one matrix ``A (m, n)``.

    Routed through the default :class:`~repro_torch.core.engine.DetEngine`:
    the rank-width guards run at plan time, *before* backend dispatch, and
    the plan is cached per shape.  ``backend="cuda"`` runs the hand-written
    kernel (its plain torch version for a tensor on the CPU);
    ``backend="torch"`` runs the eager evaluator of this module.  A tensor
    is computed on its own device; a numpy array on ``device`` (default
    ``"cuda"``).  The result is differentiable: ``torch.autograd.grad``
    runs the plan's cofactor-form backward (the CUDA backward kernel, or
    the replayed chunk walk of the torch backend).
    """
    from .engine import default_engine  # lazy: engine builds on this module
    dev = _entry_device(A, device)
    A = _as_tensor(A, dev)
    m, n = A.shape
    return default_engine().plan(
        m, n, batched=False, dtype=A.dtype, chunk=chunk, kahan=kahan,
        backend=backend, device=dev).differentiable(A)


def make_batched_evaluator(m: int, n: int, *, chunk: int = 2048,
                           backend: str = "cuda", device=None):
    """Bind the per-shape state of :func:`radic_det_batched` once.

    Returns the :class:`~repro_torch.core.engine.DetPlan` for this shape —
    a callable ``evaluate(As: (B, m, n)) -> (B,)`` for any B.  The Pascal
    table, the C(n, m) rank count and the clamped chunk are computed at
    plan time, and the plan runs the same executable as
    :func:`radic_det_batched`, so results are bit-identical to it.
    ``m > n`` is a zeros program on the plan's device.
    """
    from .engine import default_engine  # lazy: engine builds on this module
    return default_engine().plan(m, n, batched=True, chunk=chunk,
                                 backend=backend, device=device)


def aot_compile_batched(m: int, n: int, capacity: int, dtype=np.float32, *,
                        chunk: int = 2048, backend: str = "cuda",
                        device=None):
    """The plan pinned to one ``(capacity, m, n)`` batch of ``dtype``.

    The reference AOT-lowers its jnp program here; the port has nothing
    to compile per shape, so this is the capacity-keyed plan of
    :func:`make_batched_evaluator`: the same executables (bit-identical
    results), ``exe(As: (capacity, m, n)) -> (capacity,)`` and
    ``exe.grad(As, cts)``, and a batch of another size or dtype raises
    ``TypeError`` as the reference's compiled program does.
    """
    from .engine import default_engine  # lazy: engine builds on this module
    return default_engine().plan(
        m, n, batched=True, capacity=capacity, dtype=dtype, chunk=chunk,
        backend=backend, device=device)


def radic_det_batched(As, *, chunk: int = 2048, backend: str = "cuda",
                      device=None) -> torch.Tensor:
    """Radic determinants of a stack ``As (B, m, n)`` in one dispatch.

    The whole batch shares one (m, n) shape, hence one C(n, m) rank
    space, one Pascal table and one unranking per chunk.  Heterogeneously
    shaped inputs should be bucketed by shape first; see
    :mod:`repro_torch.launch.det_serve`.  Returns ``(B,)``,
    differentiable like :func:`radic_det`.
    """
    from .engine import default_engine  # lazy: engine builds on this module
    dev = _entry_device(As, device)
    As = _as_tensor(As, dev)
    if As.ndim != 3:
        raise ValueError(f"expected (B, m, n), got {tuple(As.shape)}")
    B, m, n = As.shape
    if B == 0:
        return torch.zeros((0,), dtype=As.dtype, device=As.device)
    return default_engine().plan(
        m, n, batched=True, dtype=As.dtype, chunk=chunk, backend=backend,
        device=dev).differentiable(As)
