"""--arch registry: name -> config module.

Port of ``repro/configs/registry.py``; the arch modules beside it are the
reference's, copied as data over the port's
:class:`~repro_torch.models.config.ModelConfig`."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "OPTIMIZED_OVERRIDES", "get_config", "list_archs"]

ARCHS = {
    "yi-34b": "yi_34b",
    "gemma2-9b": "gemma2_9b",
    "llama3-405b": "llama3_405b",
    "llama3-8b": "llama3_8b",
    "hymba-1.5b": "hymba_1_5b",
    "arctic-480b": "arctic_480b",
    "grok-1-314b": "grok1_314b",
    "mamba2-1.3b": "mamba2_1_3b",
    "internvl2-26b": "internvl2_26b",
    "whisper-medium": "whisper_medium",
}


# The reference's per-arch knob sets beyond the baseline, measured on its
# dry-run roofline terms.  get_config(optimized=True) applies them; the
# plain CONFIG stays the paper/baseline-faithful one so both remain
# reproducible.
OPTIMIZED_OVERRIDES: dict[str, dict] = {
    "llama3-405b": dict(attn_chunk=1024, loss_chunk=1024, seq_shard=True),
    "llama3-8b": dict(attn_chunk=1024, loss_chunk=1024, seq_shard=True),
    "yi-34b": dict(attn_chunk=1024, loss_chunk=1024, seq_shard=True),
    "gemma2-9b": dict(attn_chunk=1024, loss_chunk=1024),
    "internvl2-26b": dict(attn_chunk=1024, loss_chunk=1024,
                          seq_shard=True),
    "arctic-480b": dict(moe_impl="onehot", attn_chunk=1024,
                        loss_chunk=1024),
    "grok-1-314b": dict(moe_impl="onehot", attn_chunk=1024,
                        loss_chunk=1024),
    "hymba-1.5b": dict(attn_chunk=1024, loss_chunk=1024),
    "mamba2-1.3b": dict(loss_chunk=1024),
    "whisper-medium": dict(attn_chunk=1024),
}


def get_config(name: str, smoke: bool = False,
               optimized: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    cfg = mod.smoke() if smoke else mod.CONFIG
    if optimized and not smoke:
        cfg = cfg.replace(**OPTIMIZED_OVERRIDES.get(name, {}))
    return cfg


def list_archs() -> list[str]:
    return list(ARCHS)
