"""Host wrapper of the batched small-determinant CUDA kernel, beside its
plain torch version.

Port of ``repro/kernels/minor_det.py``: :func:`minor_det_cuda` replaces
the Pallas kernel ``minor_det_kernel`` (minor_det.py:23, wrapper
``minor_det_pallas``): ``(B, m, m)`` → ``(B,)`` determinants by Gaussian
elimination with partial pivoting (strict ``>`` pivot rule; a zero pivot
gives det 0) (``csrc/minor_det.cu``).  The reference computes in the
input dtype; here float64 computes in float64 and every other dtype in
float32, cast back to the input dtype.  m <= 16 (the matrix lives in a
thread's registers).  For a CPU tensor the wrapper runs its plain
version; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import CUDA_MAX_M

from ._launch import check_rc, counted, require_cuda
from ._launch import count as count_launch

__all__ = ["minor_det_cuda", "minor_det_plain"]


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def minor_det_plain(mats: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the K6 kernel: the same elimination
    (``batched_det_ge``, common.py:17), vectorised over the batch →
    ``(B,)`` in the input dtype."""
    B, m, _ = mats.shape
    M = mats.to(_compute_dtype(mats.dtype)).clone()
    sign = torch.ones((B,), dtype=M.dtype, device=M.device)
    rows = torch.arange(B, device=M.device)
    for k in range(m - 1):
        # first row >= k of largest |M[:, i, k]| (torch.argmax: the first)
        piv = k + torch.argmax(M[:, k:, k].abs(), dim=1)
        sign = torch.where(piv == k, sign, -sign)
        row_k, row_p = M[rows, k].clone(), M[rows, piv].clone()
        M[rows, piv] = row_k
        M[rows, k] = row_p
        p = M[:, k, k]
        safe = torch.where(p == 0, torch.ones_like(p), p)
        f = M[:, k + 1:, k] / safe[:, None]
        M[:, k + 1:, k + 1:] -= f[:, :, None] * M[:, k, None, k + 1:]
    det = sign * M.diagonal(dim1=1, dim2=2).prod(dim=1)
    return det.to(mats.dtype)


@counted
def minor_det_cuda(mats: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """Determinants of ``mats (B, m, m)`` → ``(B,)`` in ``mats.dtype``
    (K6); ``block`` matrices per block (the reference's tile)."""
    if mats.device.type == "cpu":
        return minor_det_plain(mats)
    require_cuda(mats)
    B, m, m2 = mats.shape
    if m != m2:
        raise ValueError(f"expected (B, m, m), got {tuple(mats.shape)}")
    if m > CUDA_MAX_M:
        raise ValueError(f"the CUDA kernel is built for m <= {CUDA_MAX_M}, "
                         f"got m = {m}")
    if B == 0 or m == 0:
        return torch.ones((B,), dtype=mats.dtype, device=mats.device)
    from . import _build  # lazy: builds the library at first launch
    cdt = _compute_dtype(mats.dtype)
    X = mats.to(cdt).contiguous()
    out = torch.empty((B,), dtype=cdt, device=mats.device)
    lib = _build.load()
    with torch.cuda.device(mats.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.radic_minor_det(X.data_ptr(), B, m, int(cdt == torch.float64),
                                 out.data_ptr(), int(block), stream)
    check_rc(lib, rc, "minor_det")
    count_launch(minor_det_cuda)
    return out.to(mats.dtype)
