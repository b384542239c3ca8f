"""Modality frontends — STUBS, as in the reference.

Port of ``repro/models/frontends.py``.  ``[vlm]`` / ``[audio]`` entries
specify the transformer backbone only; the real frontends (InternViT
vision tower, Whisper mel+conv stack) are out of scope.  These helpers
synthesize deterministic stand-ins for tests and examples from an
explicit torch generator, on its device.
"""

from __future__ import annotations

import torch

__all__ = ["synthetic_patch_embeds", "synthetic_frame_embeds"]


def synthetic_patch_embeds(generator: torch.Generator, batch: int,
                           n_patches: int, d_model: int,
                           dtype=torch.float32) -> torch.Tensor:
    """Stand-in for the InternViT patch-embedding output (B, P, D)."""
    return torch.randn((batch, n_patches, d_model), generator=generator,
                       dtype=dtype, device=generator.device) * 0.02


def synthetic_frame_embeds(generator: torch.Generator, batch: int,
                           n_frames: int, d_model: int,
                           dtype=torch.float32) -> torch.Tensor:
    """Stand-in for Whisper's conv-downsampled mel frames (B, T, D)."""
    return torch.randn((batch, n_frames, d_model), generator=generator,
                       dtype=dtype, device=generator.device) * 0.02
