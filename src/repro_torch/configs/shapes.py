"""Assigned input-shape sets + meta-tensor stand-ins for the dry run.

Port of ``repro/configs/shapes.py``.  Four shapes per LM architecture
(40 cells total):
  train_4k     seq 4096   × global_batch 256   (train_step)
  prefill_32k  seq 32768  × global_batch 32    (prefill_step)
  decode_32k   KV 32768   × global_batch 128   (decode_step, 1 new token)
  long_500k    KV 524288  × global_batch 1     (decode_step; sub-quadratic
                                                archs only)

``input_specs`` allocates nothing: its tensors live on the ``meta``
device, the port's ``ShapeDtypeStruct`` (a shape and a dtype, no
memory).  ``abstract_params`` and ``abstract_cache`` build the family's
model on ``meta`` too; the params come in the reference's stacked layout
(a leading ``(L, ...)`` dim on every layer leaf), so leaf names and
shapes match the reference's ``jax.eval_shape(model.init, ...)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_tree

__all__ = ["SHAPES", "Shape", "applicable", "input_specs", "abstract_params",
           "abstract_cache", "model_flops", "param_count",
           "active_param_count", "SUBQUADRATIC_FAMILIES"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str        # train | prefill | decode
    seq: int         # context length (training seq or KV length)
    batch: int       # global batch


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason recorded if skipped."""
    if shape_name == "long_500k" and cfg.family not in \
            SUBQUADRATIC_FAMILIES:
        return False, ("needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention ({cfg.family})")
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta tensors for the step's *data* inputs (not params/cache)."""
    sh = SHAPES[shape_name]
    B, S = sh.batch, sh.seq
    tok = torch.int32
    if sh.kind in ("train", "prefill"):
        keys = ("tokens", "labels") if sh.kind == "train" else ("tokens",)
        # patches count against the context
        T = S - cfg.n_patches if cfg.prefix_embeds else S
        specs = {k: _sds((B, T), tok) for k in keys}
        if cfg.prefix_embeds:
            specs["prefix_embeds"] = _sds((B, cfg.n_patches, cfg.d_model),
                                          cfg.adtype)
        if cfg.family == "audio":
            specs["frame_embeds"] = _sds((B, cfg.n_frames, cfg.d_model),
                                         cfg.adtype)
        return specs
    # decode: one new token against a seq-length cache
    return {"tokens": _sds((B, 1), tok)}


def abstract_params(cfg: ModelConfig) -> dict:
    """The family's params as meta tensors in the reference's stacked
    layout and nesting."""
    model = build_model(cfg, device="meta")
    return reference_tree(model, dict(model.named_parameters()))


def abstract_cache(cfg: ModelConfig, shape_name: str) -> dict:
    sh = SHAPES[shape_name]
    return build_model(cfg, device="meta").init_cache(sh.batch, sh.seq)


# ---------------------------------------------------------------------------
# MODEL_FLOPS for the roofline's usefulness ratio.
# ---------------------------------------------------------------------------

def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(p.shape) for p in _leaves(abstract_params(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: only top-k experts' weights count per token."""
    n = param_count(cfg)
    if cfg.family != "moe":
        return n
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return n - inactive


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """6·N·D (train) / 2·N·D (inference fwd) with N = active params."""
    sh = SHAPES[shape_name]
    n_active = active_param_count(cfg)
    if sh.kind == "train":
        tokens = sh.batch * sh.seq
        return 6.0 * n_active * tokens
    if sh.kind == "prefill":
        tokens = sh.batch * sh.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * sh.batch  # decode: one token per row
