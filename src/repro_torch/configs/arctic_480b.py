"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

dense_residual_ff=7168 derived to match the published ~10B dense share
(assignment specifies expert d_ff only) — DESIGN.md §5."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, dense_residual_ff=7168, moe_impl="scatter",
    rope_theta=10_000.0, norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16", fsdp_over_pod=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=512, n_experts=8, top_k=2,
        dense_residual_ff=64, param_dtype="float32", dtype="float32",
        remat=False, fsdp_over_pod=False)
