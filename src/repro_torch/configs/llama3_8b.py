"""llama3-8b [dense] — GQA 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0, norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=512, param_dtype="float32", dtype="float32",
        remat=False)
