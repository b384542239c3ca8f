"""Config-driven model zoo.  Port of ``repro/models``: :class:`CausalLM`
for the dense, vlm, moe, ssm and hybrid families and :class:`EncDecLM`
for audio (the Whisper-style encoder–decoder)."""

from .config import ModelConfig
from .encdec import EncDecLM
from .lm import PORTED_FAMILIES, CausalLM


def build_model(cfg: ModelConfig, *, device="cuda") -> CausalLM | EncDecLM:
    """Factory: the right model class for a config's family, its params
    allocated on ``device`` (fill them with ``init`` or the converter)."""
    if cfg.family == "audio":
        return EncDecLM(cfg, device=device)
    return CausalLM(cfg, device=device)


__all__ = ["ModelConfig", "CausalLM", "EncDecLM", "PORTED_FAMILIES",
           "build_model"]
