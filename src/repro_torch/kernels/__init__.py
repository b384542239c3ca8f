"""Hand-written CUDA kernels for the Radic hot spot (the per-rank
unrank → gather → determinant pipeline, its cofactor-form backward, and
the standalone unranking and small-determinant kernels), each beside its
plain torch version.  The CUDA sources in ``csrc/`` are compiled at first
launch (:mod:`repro_torch.kernels._build`); importing this package needs
no GPU and no compiler."""

from . import ops, ref
from ._launch import launch_counts, reset_launch_counts
from .minor_det import minor_det_cuda, minor_det_plain
from .radic_fused import (radic_batched_grad_partial_cuda,
                          radic_batched_grad_partial_plain,
                          radic_batched_partial_bygrid_cuda,
                          radic_batched_partial_cuda,
                          radic_batched_partial_plain, radic_grad_partial_cuda,
                          radic_grad_partial_plain, radic_partial_cuda,
                          radic_partial_plain)
from .unrank_kernel import unrank_cuda, unrank_plain

__all__ = ["ops", "ref", "launch_counts", "reset_launch_counts",
           "minor_det_cuda", "minor_det_plain",
           "radic_batched_grad_partial_cuda",
           "radic_batched_grad_partial_plain",
           "radic_batched_partial_bygrid_cuda", "radic_batched_partial_cuda",
           "radic_batched_partial_plain", "radic_grad_partial_cuda",
           "radic_grad_partial_plain", "radic_partial_cuda",
           "radic_partial_plain", "unrank_cuda", "unrank_plain"]
