"""Shared layer primitives: RMSNorm, RoPE, GLU MLP, initializers.

Port of ``repro/models/layers.py``.  The same math in eager torch: the
norm and the rotary embedding run in float32 and round to the input's
dtype once, GELU is the tanh approximation, and ``x @ w`` keeps the
reference's ``(in, out)`` weight orientation.

Added for the port: :class:`Leaf` states a param's shape, dtype and
initializer, :func:`draw` fills a tensor by it, and :class:`ParamTree`
holds a nested spec of leaves as module params, so each model module
writes its layout once (its ``*_spec``) and the reference's ``init_*``
functions and the models' ``init`` draw from it."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["rmsnorm", "rope", "glu_mlp", "init_glu_mlp", "glu_spec",
           "dense_init", "ACTS", "Leaf", "draw", "materialize", "ParamTree"]

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


class Leaf(NamedTuple):
    """One param: ``in_axis`` set draws :func:`dense_init` with that
    fan-in axis; otherwise every element is ``fill``."""
    shape: tuple
    dtype: torch.dtype
    in_axis: int | None = None
    fill: float = 0.0


@torch.no_grad()
def draw(leaf: Leaf, generator: torch.Generator,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """Fill ``out`` (a new tensor on ``generator``'s device if None) by
    ``leaf``'s initializer.  A stack of experts (ndim 3, fan-in axis 1)
    is drawn one expert at a time, so the float32 draw never holds more
    than one expert's matrix (arctic's stack is 4.5G elements)."""
    if out is None:
        out = torch.empty(leaf.shape, dtype=leaf.dtype,
                          device=generator.device)
    if leaf.in_axis is None:
        return out.fill_(leaf.fill)
    if len(leaf.shape) == 3 and leaf.in_axis == 1:
        for e in range(leaf.shape[0]):
            out[e].copy_(dense_init(generator, leaf.shape[1:], 0,
                                    leaf.dtype))
        return out
    return out.copy_(dense_init(generator, leaf.shape, leaf.in_axis,
                                leaf.dtype))


def materialize(spec: dict, generator: torch.Generator) -> dict:
    """A nested spec of leaves as a nested dict of drawn tensors, in the
    spec's order."""
    return {k: materialize(v, generator) if isinstance(v, dict)
            else draw(v, generator) for k, v in spec.items()}


class ParamTree(nn.Module):
    """A nested spec of :class:`Leaf` held as module params: a
    (non-trainable) parameter per leaf and a child tree per dict, each
    reachable as ``tree[name]``.  Allocated uninitialized on ``device``
    (``"meta"`` allocates nothing)."""

    def __init__(self, spec: dict, device):
        super().__init__()
        self._spec = spec
        for name, leaf in spec.items():
            if isinstance(leaf, dict):
                setattr(self, name, ParamTree(leaf, device))
            else:
                setattr(self, name, nn.Parameter(
                    torch.empty(leaf.shape, dtype=leaf.dtype, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> dict:
        """The params as the reference's (per-layer) nested dict."""
        return {name: self[name].tree() if isinstance(leaf, dict)
                else self[name] for name, leaf in self._spec.items()}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "ParamTree":
        """Draw every leaf in the spec's order."""
        for name, leaf in self._spec.items():
            if isinstance(leaf, dict):
                self[name].init(generator)
            else:
                draw(leaf, generator, out=self[name])
        return self


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


def glu_spec(d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {"w_gate": Leaf((d_model, d_ff), dtype, 0),
            "w_up": Leaf((d_model, d_ff), dtype, 0),
            "w_down": Leaf((d_ff, d_model), dtype, 0)}


def init_glu_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype) -> dict:
    return materialize(glu_spec(d_model, d_ff, dtype), generator)


def glu_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated-linear-unit MLP (SwiGLU / GeGLU by `act`)."""
    h = ACTS[act](x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
