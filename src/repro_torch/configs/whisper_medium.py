"""whisper-medium [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

"24L" read as 24 encoder + 24 decoder layers (the published medium
config).  kv=16 with 16 heads => plain MHA.  Backbone adaptations
(DESIGN.md §5): GLU MLP + RMSNorm + RoPE in place of whisper's
GELU-MLP/LayerNorm/learned-abs-pos (backbone-stub semantics); decoder
positions extended to the assigned 32k shapes."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    enc_dec=True, n_enc_layers=24, n_frames=1500,
    act="gelu", norm_eps=1e-5,
    param_dtype="bfloat16", dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, n_frames=12,
        param_dtype="float32", dtype="float32", remat=False)
