"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, top_k=2, moe_impl="scatter",
    attn_logit_softcap=30.0, final_logit_softcap=30.0,
    rope_theta=10_000.0, norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16", fsdp_over_pod=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=512, n_experts=4, top_k=2,
        param_dtype="float32", dtype="float32", remat=False,
        fsdp_over_pod=False)
