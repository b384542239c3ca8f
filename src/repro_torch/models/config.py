"""Model configuration shared by the whole zoo.

Port of ``repro/models/config.py``: the same frozen dataclass, field for
field, so ``dataclasses.asdict`` of a config equals the reference's.
:attr:`ModelConfig.pdtype` and :attr:`ModelConfig.adtype` return torch
dtypes.  ``remat``, ``remat_policy`` and ``scan_layers`` are kept as
fields for the training and dry-run slices; serving ignores them (layers
run one after another in eager torch)."""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]

__all__ = ["ModelConfig", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy-style dtype name (``"bfloat16"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    rope_theta: float = 10_000.0
    attn_window: int | None = None            # sliding window size
    local_global_period: int | None = None    # gemma2: even layers local
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    attn_chunk: int = 0                       # KV-chunked online softmax
    #                                           (flash-style): never holds
    #                                           the full (…,S,T) scores
    act: str = "silu"                         # silu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_block_norm: bool = False             # gemma2 post-norms
    scale_embeddings: bool = False            # gemma2: embed * sqrt(d)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual_ff: int = 0                # arctic parallel dense branch
    capacity_factor: float = 1.25
    moe_impl: str = "onehot"                  # onehot (baseline) | scatter
    moe_group_size: int = 2048                # GShard dispatch group (tokens)

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_state_dtype: str = "float32"          # decode-state storage dtype

    # hybrid (hymba): parallel attn + ssm heads in each block
    hybrid_heads: bool = False

    # enc-dec / modality frontends (stubs provide precomputed embeddings)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500                      # whisper encoder positions
    n_patches: int = 256                      # vlm prefix length
    prefix_embeds: bool = False               # vlm: image embeds prefix

    # numerics / structure
    param_dtype: str = "float32"
    dtype: str = "bfloat16"                   # activation/compute dtype
    remat: bool = True
    remat_policy: str = "nothing"             # nothing | dots (save matmuls)
    scan_layers: bool = True
    fsdp_over_pod: bool = False               # large models: FSDP over pods
    seq_shard: bool = False                   # sequence-parallel activations
    loss_chunk: int = 0                       # chunked CE (0 = off): never
    #                                           materializes (B,S,V) logits
    cache_update: str = "onehot"              # onehot | dus (decode cache)

    # ---- derived ----
    @property
    def qdim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kvdim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        # mamba2 conv runs over [x, B, C] concatenated (n_groups = 1)
        return self.d_inner + 2 * self.ssm_state

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def is_local_layer(self, idx: int) -> bool:
        """gemma2-style alternation: even layers sliding-window."""
        if self.attn_window is None:
            return False
        if self.local_global_period is None:
            return True  # window on every layer
        return idx % self.local_global_period != self.local_global_period - 1

    def validate(self) -> None:
        assert self.qdim > 0 or self.family == "ssm"
        if self.family in ("dense", "vlm", "audio", "hybrid", "moe"):
            assert self.n_heads % self.n_kv_heads == 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.family == "audio":
            assert self.enc_dec and self.n_enc_layers > 0
