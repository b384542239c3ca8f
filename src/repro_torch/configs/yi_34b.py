"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    rope_theta=5_000_000.0, norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=512, param_dtype="float32", dtype="float32",
        remat=False)
