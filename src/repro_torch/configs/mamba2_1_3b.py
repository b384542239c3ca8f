"""mamba2-1.3b [ssm] — SSD state-space duality [arXiv:2405.21060].

Attention-free: pure SSD blocks (d_inner=4096, 64 heads of dim 64,
d_state=128, chunk 256 — paper-standard)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=1, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, norm_eps=1e-5, tie_embeddings=True,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, param_dtype="float32",
        dtype="float32", remat=False)
