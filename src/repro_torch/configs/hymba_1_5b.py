"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

Adaptations (DESIGN.md §5): meta-tokens stubbed; SWA window 1024 with a
full-attention layer every 16 (the paper uses first/middle/last full)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_window=1024, local_global_period=16,
    rope_theta=10_000.0, norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=8, attn_window=8, local_global_period=2,
        param_dtype="float32", dtype="float32", remat=False)
