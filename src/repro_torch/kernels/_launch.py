"""Bookkeeping shared by the kernel wrappers: launch counts, the device
rule and the CUDA error code a launch returns.

Every wrapper that launches a kernel is registered with :func:`counted`,
which gives it a ``launches`` attribute; :func:`count` adds one where the
kernel is launched and nowhere else, and :func:`reset_launch_counts` sets
every registered count to 0."""

from __future__ import annotations

import threading

import torch

__all__ = ["counted", "count", "reset_launch_counts", "require_cuda",
           "check_rc"]

_lock = threading.Lock()
_wrappers: list = []


def counted(wrapper):
    """Register a wrapper's launch count (a decorator)."""
    wrapper.launches = 0
    with _lock:
        _wrappers.append(wrapper)
    return wrapper


def count(wrapper) -> None:
    with _lock:
        wrapper.launches += 1


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    with _lock:
        for wrapper in _wrappers:
            wrapper.launches = 0


def require_cuda(t: torch.Tensor) -> None:
    """A wrapper runs its plain version for a CPU tensor and its kernel
    for a CUDA tensor; anything else is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {t.device}")


def check_rc(lib, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"{what} CUDA kernel launch failed: "
            f"{lib.radic_error_string(rc).decode()} (code {rc})")
