"""Host wrappers of the fused Radic CUDA kernels, each beside its plain
torch version.

Port of ``repro/kernels/radic_fused.py``, all four of its Pallas kernels:

* :func:`radic_batched_partial_cuda` replaces the Pallas kernel
  ``radic_batched_combo_kernel`` (radic_fused.py:156, wrapper
  ``radic_batched_partial_pallas``): per matrix of a stack
  ``As (B, m, n)``, ``Σ sign(B_q)·det(A_b[:, B_q])`` over the ranks
  ``[q_start, q_start + count)`` → ``(B,)``.
* :func:`radic_partial_cuda` replaces ``radic_fused_kernel``
  (radic_fused.py:39, wrapper ``radic_partial_pallas``): the same sum for
  one matrix ``A (m, n)`` → a scalar.  It launches the same CUDA kernel at
  B = 1 and keeps its own launch count.

The kernel (``csrc/radic_fused.cu``) computes in float32 whatever the
input dtype and the wrapper casts the result back.  A wrapper given a
tensor on the CPU runs its plain version (``*_plain``); given a CUDA
tensor it launches the kernel or raises — it never falls back.  Every
launch adds one to the wrapper's ``launches`` attribute.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import CUDA_MAX_M
from repro_torch.core.pascal import INT32_MAX
from repro_torch.core.radic import (signed_minor_pullback_batched,
                                    signed_minor_sum_batched)
from repro_torch.core.unrank import unrank_torch

from ._launch import check_rc, counted, require_cuda, reset_launch_counts
from ._launch import count as count_launch

__all__ = ["radic_batched_partial_cuda", "radic_batched_partial_plain",
           "radic_partial_cuda", "radic_partial_plain",
           "radic_batched_grad_partial_cuda",
           "radic_batched_grad_partial_plain", "radic_grad_partial_cuda",
           "radic_grad_partial_plain", "radic_batched_partial_bygrid_cuda",
           "grid_blocks", "grad_grid_blocks", "reset_launch_counts", "TILE",
           "MAX_BLOCKS"]

TILE = 256            # ranks per tile == threads per block (common.cuh)
BATCH_CHUNK = 16      # matrices per block (common.cuh kBatchChunk)
MAX_BLOCKS = 1024     # fixed rank-walk width: bounds the partials buffer
GRAD_MAX_BLOCKS = 1024      # the same for the gradient kernel (K3) ...
GRAD_PARTIAL_FLOATS = 1 << 17  # ... whose partials hold G·m·n <= this
PLAIN_CHUNK = 2048    # ranks per step of the plain versions


def grid_blocks(count: int) -> int:
    """Blocks of the rank walk: one per tile, at most ``MAX_BLOCKS``.
    A function of ``count`` only, so the reduction order (and with it
    every bit of a result) never depends on the batch."""
    return max(1, min(-(-count // TILE), MAX_BLOCKS))


def grad_grid_blocks(count: int, m: int, n: int, tile: int) -> int:
    """Blocks of the gradient kernel's rank walk: one per tile of
    ``tile`` ranks (the kernel's own, ``radic_grad_tile(m)``), at most
    ``GRAD_MAX_BLOCKS``, and few enough that each matrix's partials
    ``(G, m, n)`` hold at most ``GRAD_PARTIAL_FLOATS`` floats (512 KB).
    A function of the rank range and the shape only, never of B."""
    return max(1, min(-(-count // tile), GRAD_MAX_BLOCKS,
                      GRAD_PARTIAL_FLOATS // (m * n)))


# ------------------------------------------------------------ plain versions
def radic_batched_partial_plain(As: torch.Tensor, table: torch.Tensor,
                                q_start: int, count: int, *,
                                dtype: torch.dtype = torch.float32,
                                chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of the K1 kernel: the same rank range, walked
    in chunks of ``chunk`` ranks (unrank → gather → ``torch.linalg.det``
    → signed masked sum), accumulated in ``dtype`` (float32 by default;
    float64 for a ground truth) → ``(B,)`` in ``dtype``."""
    B, m, n = As.shape
    X = As.to(dtype)
    acc = torch.zeros((B,), dtype=dtype, device=As.device)
    chunk = max(1, min(chunk, count))
    idx = torch.arange(chunk, dtype=torch.int64, device=As.device)
    for base in range(0, count, chunk):
        offs = base + idx
        valid = offs < count
        combos = unrank_torch(q_start + torch.where(valid, offs, 0), n, m,
                              table)
        acc = acc + signed_minor_sum_batched(X, combos, valid)
    return acc


def radic_partial_plain(A: torch.Tensor, table: torch.Tensor, q_start: int,
                        count: int, *, dtype: torch.dtype = torch.float32,
                        chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of the K2 kernel: one matrix → a scalar."""
    return radic_batched_partial_plain(A[None], table, q_start, count,
                                       dtype=dtype, chunk=chunk)[0]


def radic_batched_grad_partial_plain(As: torch.Tensor, cts: torch.Tensor,
                                     table: torch.Tensor, q_start: int,
                                     count: int, *,
                                     dtype: torch.dtype = torch.float32,
                                     chunk: int = PLAIN_CHUNK
                                     ) -> torch.Tensor:
    """Plain torch version of the K3 kernel: the forward's rank range
    replayed in chunks of ``chunk`` ranks, each pulling the cotangents
    ``cts (B,)`` back through its signed minor sum in closed form
    (cofactors, :func:`~repro_torch.core.radic.cofactors`) and adding
    the result to the running gradient, in ``dtype`` (float32 by default;
    float64 for a ground truth) → ``(B, m, n)`` in ``dtype``."""
    B, m, n = As.shape
    X = As.to(dtype)
    c = torch.as_tensor(cts, device=As.device).to(dtype).reshape(B)
    g = torch.zeros((B, m, n), dtype=dtype, device=As.device)
    chunk = max(1, min(chunk, count))
    idx = torch.arange(chunk, dtype=torch.int64, device=As.device)
    for base in range(0, count, chunk):
        offs = base + idx
        valid = offs < count
        combos = unrank_torch(q_start + torch.where(valid, offs, 0), n, m,
                              table)
        g = g + signed_minor_pullback_batched(X, c, combos, valid)
    return g


def radic_grad_partial_plain(A: torch.Tensor, ct, table: torch.Tensor,
                             q_start: int, count: int, *,
                             dtype: torch.dtype = torch.float32,
                             chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain torch version of the K3 kernel at B = 1: ``A (m, n)``, a
    scalar cotangent → ``(m, n)``."""
    cts = torch.as_tensor(ct, device=A.device).reshape(1)
    return radic_batched_grad_partial_plain(A[None], cts, table, q_start,
                                            count, dtype=dtype,
                                            chunk=chunk)[0]


# ------------------------------------------------------------------ launches
def _check(As: torch.Tensor, table: torch.Tensor, q_start: int,
           count: int, max_batch: int = BATCH_CHUNK * 65535) -> None:
    B, m, n = As.shape
    if not 1 <= m <= CUDA_MAX_M:
        raise ValueError(f"the CUDA kernel is built for 1 <= m <= "
                         f"{CUDA_MAX_M}, got m = {m}")
    if n < m:
        raise ValueError(f"expected m <= n, got ({m}, {n})")
    if tuple(table.shape) != (n + 1, m + 1):
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({n + 1}, {m + 1})")
    if q_start < 0 or count < 0 or q_start + count > INT32_MAX + 1:
        raise ValueError(f"rank range [{q_start}, {q_start + count}) is "
                         "outside the kernel's int32 ranks")
    if B > max_batch:
        raise ValueError(f"batch {B} exceeds {max_batch}")


def _launch(As: torch.Tensor, table: torch.Tensor, q_start: int,
            count: int, *, bygrid: bool = False) -> torch.Tensor:
    """Launch K1's kernel pair (K4's with ``bygrid``) on the current
    stream → ``(B,)`` float32."""
    from . import _build  # lazy: builds the library at first launch
    _check(As, table, q_start, count,
           max_batch=65535 if bygrid else BATCH_CHUNK * 65535)
    B = As.shape[0]
    X = As.to(torch.float32).contiguous()
    T = table.to(device=As.device, dtype=torch.int32).contiguous()
    grid = grid_blocks(count)
    partials = torch.empty((grid, B), dtype=torch.float32, device=As.device)
    out = torch.empty((B,), dtype=torch.float32, device=As.device)
    lib = _build.load()
    entry = lib.radic_bygrid_partial if bygrid else lib.radic_batched_partial
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(X.data_ptr(), B, As.shape[1], As.shape[2], T.data_ptr(),
                   int(q_start), int(count), partials.data_ptr(), grid,
                   out.data_ptr(), stream)
    check_rc(lib, rc, "radic")
    return out


def _launch_grad(As: torch.Tensor, cts: torch.Tensor, table: torch.Tensor,
                 q_start: int, count: int) -> torch.Tensor:
    """Launch K3's kernel pair on the current stream → ``(B, m, n)``
    float32."""
    from . import _build  # lazy: builds the library at first launch
    _check(As, table, q_start, count)
    B, m, n = As.shape
    X = As.to(torch.float32).contiguous()
    C = torch.as_tensor(cts, device=As.device).to(torch.float32) \
        .reshape(B).contiguous()
    T = table.to(device=As.device, dtype=torch.int32).contiguous()
    lib = _build.load()
    grid = grad_grid_blocks(count, m, n, lib.radic_grad_tile(m))
    partials = torch.empty((grid, B, m, n), dtype=torch.float32,
                           device=As.device)
    out = torch.empty((B, m, n), dtype=torch.float32, device=As.device)
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.radic_batched_grad_partial(
            X.data_ptr(), C.data_ptr(), B, m, n, T.data_ptr(), int(q_start),
            int(count), partials.data_ptr(), grid, out.data_ptr(), stream)
    check_rc(lib, rc, "radic gradient")
    return out


@counted
def radic_batched_partial_cuda(As: torch.Tensor, table: torch.Tensor,
                               q_start: int, count: int) -> torch.Tensor:
    """Per-matrix Σ sign·det over ranks [q_start, q_start+count) of a
    stack ``As (B, m, n)`` → ``(B,)`` in ``As.dtype`` (K1)."""
    if As.device.type == "cpu":
        return radic_batched_partial_plain(As, table, q_start,
                                           count).to(As.dtype)
    require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros((0,), dtype=As.dtype, device=As.device)
    out = _launch(As, table, q_start, count)
    count_launch(radic_batched_partial_cuda)
    return out.to(As.dtype)


@counted
def radic_partial_cuda(A: torch.Tensor, table: torch.Tensor, q_start: int,
                       count: int) -> torch.Tensor:
    """Σ sign·det over ranks [q_start, q_start+count) of one matrix
    ``A (m, n)`` → a 0-d tensor in ``A.dtype`` (K2: the K1 kernel at
    B = 1)."""
    if A.device.type == "cpu":
        return radic_partial_plain(A, table, q_start, count).to(A.dtype)
    require_cuda(A)
    out = _launch(A[None], table, q_start, count)
    count_launch(radic_partial_cuda)
    return out[0].to(A.dtype)


@counted
def radic_batched_partial_bygrid_cuda(As: torch.Tensor, table: torch.Tensor,
                                      q_start: int, count: int
                                      ) -> torch.Tensor:
    """K1's function on the by-grid kernel (K4): ``(B,)`` in
    ``As.dtype``, equal to :func:`radic_batched_partial_cuda` bit for
    bit.  The function is K1's, so its plain version is K1's too."""
    if As.device.type == "cpu":
        return radic_batched_partial_plain(As, table, q_start,
                                           count).to(As.dtype)
    require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros((0,), dtype=As.dtype, device=As.device)
    out = _launch(As, table, q_start, count, bygrid=True)
    count_launch(radic_batched_partial_bygrid_cuda)
    return out.to(As.dtype)


@counted
def radic_batched_grad_partial_cuda(As: torch.Tensor, cts: torch.Tensor,
                                    table: torch.Tensor, q_start: int,
                                    count: int) -> torch.Tensor:
    """Cotangents ``cts (B,)`` pulled back through the signed minor sum
    over ranks [q_start, q_start+count) of ``As (B, m, n)`` →
    ``(B, m, n)`` in ``As.dtype`` (K3)."""
    if As.device.type == "cpu":
        return radic_batched_grad_partial_plain(As, cts, table, q_start,
                                                count).to(As.dtype)
    require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros_like(As)
    out = _launch_grad(As, cts, table, q_start, count)
    count_launch(radic_batched_grad_partial_cuda)
    return out.to(As.dtype)


@counted
def radic_grad_partial_cuda(A: torch.Tensor, ct, table: torch.Tensor,
                            q_start: int, count: int) -> torch.Tensor:
    """A scalar cotangent pulled back through the signed minor sum of one
    matrix ``A (m, n)`` → ``(m, n)`` in ``A.dtype`` (K3's kernel at
    B = 1, counted on its own)."""
    if A.device.type == "cpu":
        return radic_grad_partial_plain(A, ct, table, q_start,
                                        count).to(A.dtype)
    require_cuda(A)
    cts = torch.as_tensor(ct, device=A.device).reshape(1)
    out = _launch_grad(A[None], cts, table, q_start, count)
    count_launch(radic_grad_partial_cuda)
    return out[0].to(A.dtype)
