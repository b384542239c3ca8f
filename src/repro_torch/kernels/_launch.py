"""Bookkeeping shared by the kernel wrappers: launch counts, the device
rule and the CUDA error code a launch returns.

Every wrapper that launches a kernel is registered with :func:`counted`,
which gives it a ``launches`` attribute, a ``wide_launches`` one and a
``prefix_launches`` one; :func:`count` adds one to the first where the
kernel is launched and nowhere else, to the second too where that launch
went to a kernel of the wide path (m >= 17: the warp kernels, the prefix
walk, and K6's block kernel), and to the third where it went to the
prefix walk (``csrc/radic_prefix.cuh``); :func:`reset_launch_counts` sets
every registered count to 0."""

from __future__ import annotations

import threading

import torch

__all__ = ["counted", "count", "reset_launch_counts", "launch_counts",
           "require_cuda", "check_rc"]

_lock = threading.Lock()
_wrappers: list = []


def counted(wrapper):
    """Register a wrapper's launch count (a decorator)."""
    wrapper.launches = 0
    wrapper.wide_launches = 0
    wrapper.prefix_launches = 0
    with _lock:
        _wrappers.append(wrapper)
    return wrapper


def count(wrapper, wide: bool = False, prefix: bool = False) -> None:
    with _lock:
        wrapper.launches += 1
        wrapper.wide_launches += int(wide)
        wrapper.prefix_launches += int(prefix)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    with _lock:
        for wrapper in _wrappers:
            wrapper.launches = 0
            wrapper.wide_launches = 0
            wrapper.prefix_launches = 0


def launch_counts() -> dict[str, int]:
    """Every registered wrapper's launch count, by its name."""
    with _lock:
        return {wrapper.__name__: wrapper.launches for wrapper in _wrappers}


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
