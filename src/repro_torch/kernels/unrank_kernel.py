"""Host wrapper of the batched unranking CUDA kernel, beside its plain
torch version.

Port of ``repro/kernels/unrank_kernel.py``: :func:`unrank_cuda` replaces
the Pallas kernel ``unrank_kernel`` (unrank_kernel.py:23, wrapper
``unrank_pallas``): int32 ranks ``(B,)`` → 1-indexed m-subsets of
``{1..n}`` in dictionary order, ``(B, m)`` int32, by the n-step walk over
the ``(n+1, m+1)`` Pascal table (``csrc/unrank.cu``).  There is no bound
on m.  The wrapper checks the table's shape on either device; then, for
a CPU tensor, it runs its plain version; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.unrank import unrank_torch

from ._launch import check_rc, counted, require_cuda
from ._launch import count as count_launch

__all__ = ["unrank_cuda", "unrank_plain"]


def unrank_plain(qs: torch.Tensor, n: int, m: int,
                 table: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the K5 kernel: the same walk on int64
    lanes (:func:`~repro_torch.core.unrank.unrank_torch`) → int32."""
    return unrank_torch(qs.to(torch.int32), n, m, table).to(torch.int32)


@counted
def unrank_cuda(qs: torch.Tensor, n: int, m: int, table: torch.Tensor, *,
                block: int = 256) -> torch.Tensor:
    """Ranks ``qs (B,)`` → 1-indexed combos ``(B, m)`` int32 (K5);
    ``block`` ranks per block (the reference's tile)."""
    if tuple(table.shape) != (n + 1, m + 1):  # on either device
        raise ValueError(f"table shape {tuple(table.shape)} != "
                         f"({n + 1}, {m + 1})")
    if qs.device.type == "cpu":
        return unrank_plain(qs, n, m, table)
    require_cuda(qs)
    B = qs.shape[0]
    if B == 0 or m == 0:
        return torch.zeros((B, m), dtype=torch.int32, device=qs.device)
    from . import _build  # lazy: builds the library at first launch
    Q = qs.to(torch.int32).contiguous()
    T = table.to(device=qs.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, m), dtype=torch.int32, device=qs.device)
    lib = _build.load()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.radic_unrank(Q.data_ptr(), B, n, m, T.data_ptr(),
                              out.data_ptr(), int(block), stream)
    check_rc(lib, rc, "unrank")
    count_launch(unrank_cuda)
    return out
