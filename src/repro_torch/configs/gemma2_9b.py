"""gemma2-9b [dense] — local+global alternating, logit softcaps
[arXiv:2408.00118; hf].  head_dim=256 per HF config (16*256=4096 != d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    rope_theta=10_000.0, norm_eps=1e-6, act="gelu",
    attn_window=4096, local_global_period=2,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norm=True, scale_embeddings=True, tie_embeddings=True,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, attn_window=8,
        param_dtype="float32", dtype="float32", remat=False)
