"""Hymba-style hybrid block: attention heads and SSM heads run in
*parallel* on the same input and are fused by learned per-path gates
(arXiv:2411.13676 §2; meta-tokens stubbed, as in the reference).

Port of ``repro/models/hybrid.py``: the same functions over explicit
param mappings.  ``gate`` is float32 of ndim 1, which the models' cast
to the activation dtype leaves alone."""

from __future__ import annotations

import torch

from .attention import attn_decode, attn_forward, attn_spec
from .config import ModelConfig
from .layers import Leaf, materialize
from .ssm import ssm_decode, ssm_forward, ssm_spec

__all__ = ["init_hybrid", "hybrid_spec", "hybrid_forward", "hybrid_decode"]


def hybrid_spec(cfg: ModelConfig) -> dict:
    return {"attn": attn_spec(cfg), "ssm": ssm_spec(cfg),
            "gate": Leaf((2,), torch.float32)}  # softmax-ed path weights


def init_hybrid(generator: torch.Generator, cfg: ModelConfig) -> dict:
    return materialize(hybrid_spec(cfg), generator)


def _mix(p, a, s):
    w = torch.softmax(p["gate"], dim=-1)
    return (w[0] * a.float() + w[1] * s.float()).to(a.dtype)


def hybrid_forward(p, x, cfg: ModelConfig, *, positions, is_local):
    a = attn_forward(p["attn"], x, cfg, positions=positions,
                     is_local=is_local)
    s = ssm_forward(p["ssm"], x, cfg)
    return _mix(p, a, s)


def hybrid_decode(p, x, cache, pos, cfg: ModelConfig, *, is_local):
    """cache = dict(k, v, conv, state) for this layer."""
    a, k, v = attn_decode(p["attn"], x, cache["k"], cache["v"], pos, cfg,
                          is_local=is_local)
    s, conv, state = ssm_decode(p["ssm"], x, cache["conv"], cache["state"],
                                cfg)
    y = _mix(p, a, s)
    return y, {"k": k, "v": v, "conv": conv, "state": state}
