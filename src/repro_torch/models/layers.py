"""Shared layer primitives: RMSNorm, RoPE, GLU MLP, initializers.

Port of ``repro/models/layers.py``.  The same math in eager torch: the
norm and the rotary embedding run in float32 and round to the input's
dtype once, GELU is the tanh approximation, and ``x @ w`` keeps the
reference's ``(in, out)`` weight orientation."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "rope", "glu_mlp", "init_glu_mlp", "dense_init",
           "ACTS"]

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def dense_init(generator: torch.Generator, shape, in_axis: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal fan-in init (0.02-capped, LLaMA-style): a float32
    draw on [-2, 2] times ``min(0.02, fan_in ** -0.5)``, then cast, on
    ``generator``'s device.  The reference's distribution; not its bits
    (torch's generator is not jax's PRNG)."""
    fan_in = shape[in_axis]
    std = min(0.02, fan_in ** -0.5)
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMS norm with (1 + w) scaling (gemma/llama compatible)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x (..., S, H, D), positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def init_glu_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), 0, dtype),
        "w_up": dense_init(generator, (d_model, d_ff), 0, dtype),
        "w_down": dense_init(generator, (d_ff, d_model), 0, dtype),
    }


def glu_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated-linear-unit MLP (SwiGLU / GeGLU by `act`)."""
    h = ACTS[act](x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
