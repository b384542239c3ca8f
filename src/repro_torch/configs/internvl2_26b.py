"""internvl2-26b [vlm] — InternViT + InternLM2-20B [arXiv:2404.16821; hf].

Backbone only: the vision tower is a STUB; input_specs feeds 256
precomputed patch embeddings per image as a prefix (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    prefix_embeds=True, n_patches=256,
    rope_theta=1_000_000.0, norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=512, n_patches=4, param_dtype="float32",
        dtype="float32", remat=False)
