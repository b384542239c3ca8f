"""Hand-written CUDA kernels for the Radic hot spot (the per-rank
unrank → gather → determinant pipeline), each beside its plain torch
version.  The CUDA sources in ``csrc/`` are compiled at first launch
(:mod:`repro_torch.kernels._build`); importing this package needs no
GPU and no compiler."""

from . import ops, ref
from .radic_fused import (radic_batched_partial_cuda,
                          radic_batched_partial_plain, radic_partial_cuda,
                          radic_partial_plain, reset_launch_counts)

__all__ = ["ops", "ref", "radic_batched_partial_cuda",
           "radic_batched_partial_plain", "radic_partial_cuda",
           "radic_partial_plain", "reset_launch_counts"]
