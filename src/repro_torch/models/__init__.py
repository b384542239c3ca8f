"""Config-driven model zoo.  Port of ``repro/models``: the dense and vlm
families of :class:`CausalLM` so far (``moe``, ``ssm``, ``hybrid`` and the
``audio`` encoder–decoder raise ``NotImplementedError``)."""

from .config import ModelConfig
from .lm import PORTED_FAMILIES, CausalLM


def build_model(cfg: ModelConfig, *, device="cuda") -> CausalLM:
    """Factory: the right model class for a config's family, its params
    allocated on ``device`` (fill them with ``init`` or the converter)."""
    if cfg.family == "audio":
        raise NotImplementedError(
            "audio (the encoder-decoder) is not ported yet: its serving "
            "path is ROADMAP queue 1 item 10 (moe, ssm, hybrid, encdec "
            "serving)")
    return CausalLM(cfg, device=device)


__all__ = ["ModelConfig", "CausalLM", "PORTED_FAMILIES", "build_model"]
