"""Radic determinant of an m×n matrix (paper Definition 3) — eager torch path.

Port of ``repro/core/radic.py`` (forward only).  ``det(A) = Σ_q
(−1)^(r + s_q) · det(A[:, B_q])`` over all ``C(n, m)`` column subsets
``B_q`` in dictionary order, where ``r = m(m+1)/2`` and ``s_q`` is the
(1-indexed) column sum of ``B_q``.

This is the ``"torch"`` backend, the twin of the reference's ``jnp``
backend: the rank space is streamed in fixed-size chunks, each chunk is
unranked independently, its transposed minors are gathered and fed to
``torch.linalg.det``, and the signed terms are accumulated.  The chunk
walk is a plain Python loop (the reference's ``fori_loop``).  It runs on
whatever device its input lies on.
"""

from __future__ import annotations

import numpy as np
import torch

from .unrank import unrank_torch

__all__ = ["radic_det", "radic_det_batched", "signed_minor_sum",
           "signed_minor_sum_batched", "radic_sign", "resolve_device"]


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
    ``"cuda"``).
    """
    from .engine import default_engine  # lazy: engine builds on this module
    dev = _entry_device(A, device)
    A = _as_tensor(A, dev)
    m, n = A.shape
    return default_engine().plan(
        m, n, batched=False, dtype=A.dtype, chunk=chunk, kahan=kahan,
        backend=backend, device=dev)(A)


def radic_det_batched(As, *, chunk: int = 2048, backend: str = "cuda",
                      device=None) -> torch.Tensor:
    """Radic determinants of a stack ``As (B, m, n)`` in one dispatch.

    The whole batch shares one (m, n) shape, hence one C(n, m) rank
    space, one Pascal table and one unranking per chunk.  Heterogeneously
    shaped inputs should be bucketed by shape first; see
    :mod:`repro_torch.launch.det_serve`.  Returns ``(B,)``.
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
        device=dev)(As)
