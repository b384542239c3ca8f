"""Host wrappers of the fused Radic CUDA kernel, each beside its plain
torch version.

Port of ``repro/kernels/radic_fused.py``:

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

import threading

import torch

from repro_torch.core.engine import CUDA_MAX_M
from repro_torch.core.pascal import INT32_MAX
from repro_torch.core.radic import signed_minor_sum_batched
from repro_torch.core.unrank import unrank_torch

__all__ = ["radic_batched_partial_cuda", "radic_batched_partial_plain",
           "radic_partial_cuda", "radic_partial_plain", "grid_blocks",
           "reset_launch_counts", "TILE", "MAX_BLOCKS"]

TILE = 256            # ranks per tile == threads per block (common.cuh)
BATCH_CHUNK = 16      # matrices per block (common.cuh kBatchChunk)
MAX_BLOCKS = 1024     # fixed rank-walk width: bounds the partials buffer
PLAIN_CHUNK = 2048    # ranks per step of the plain versions

_count_lock = threading.Lock()


def grid_blocks(count: int) -> int:
    """Blocks of the rank walk: one per tile, at most ``MAX_BLOCKS``.
    A function of ``count`` only, so the reduction order (and with it
    every bit of a result) never depends on the batch."""
    return max(1, min(-(-count // TILE), MAX_BLOCKS))


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


# ------------------------------------------------------------------ launches
def _check(As: torch.Tensor, table: torch.Tensor, q_start: int,
           count: int) -> None:
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
    if B > BATCH_CHUNK * 65535:
        raise ValueError(f"batch {B} exceeds {BATCH_CHUNK * 65535}")


def _launch(As: torch.Tensor, table: torch.Tensor, q_start: int,
            count: int) -> torch.Tensor:
    """Launch the kernel pair on the current stream → ``(B,)`` float32."""
    from . import _build  # lazy: builds the library at first launch
    _check(As, table, q_start, count)
    B = As.shape[0]
    X = As.to(torch.float32).contiguous()
    T = table.to(device=As.device, dtype=torch.int32).contiguous()
    grid = grid_blocks(count)
    partials = torch.empty((grid, B), dtype=torch.float32, device=As.device)
    out = torch.empty((B,), dtype=torch.float32, device=As.device)
    lib = _build.load()
    with torch.cuda.device(As.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.radic_batched_partial(
            X.data_ptr(), B, As.shape[1], As.shape[2], T.data_ptr(),
            int(q_start), int(count), partials.data_ptr(), grid,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"radic CUDA kernel launch failed: "
            f"{lib.radic_error_string(rc).decode()} (code {rc})")
    return out


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {t.device}")


def radic_batched_partial_cuda(As: torch.Tensor, table: torch.Tensor,
                               q_start: int, count: int) -> torch.Tensor:
    """Per-matrix Σ sign·det over ranks [q_start, q_start+count) of a
    stack ``As (B, m, n)`` → ``(B,)`` in ``As.dtype`` (K1)."""
    if As.device.type == "cpu":
        return radic_batched_partial_plain(As, table, q_start,
                                           count).to(As.dtype)
    _require_cuda(As)
    if As.shape[0] == 0:
        return torch.zeros((0,), dtype=As.dtype, device=As.device)
    out = _launch(As, table, q_start, count)
    _count(radic_batched_partial_cuda)
    return out.to(As.dtype)


def radic_partial_cuda(A: torch.Tensor, table: torch.Tensor, q_start: int,
                       count: int) -> torch.Tensor:
    """Σ sign·det over ranks [q_start, q_start+count) of one matrix
    ``A (m, n)`` → a 0-d tensor in ``A.dtype`` (K2: the K1 kernel at
    B = 1)."""
    if A.device.type == "cpu":
        return radic_partial_plain(A, table, q_start, count).to(A.dtype)
    _require_cuda(A)
    out = _launch(A[None], table, q_start, count)
    _count(radic_partial_cuda)
    return out[0].to(A.dtype)


radic_batched_partial_cuda.launches = 0
radic_partial_cuda.launches = 0


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    with _count_lock:
        radic_batched_partial_cuda.launches = 0
        radic_partial_cuda.launches = 0
