"""The yardstick of a language model's step: model FLOPs per token and the
H100's dense peaks by compute dtype.

A token's FLOPs are 2 × the weights it is multiplied by, counting only
the experts it is routed to, plus the attention score and value products
over the positions it sees (``4 · heads · head_dim · context``, a
sliding-window layer seeing at most its window) and, in an SSM layer,
the state's update and read-out (``2 · 2 · heads · head_dim · state``).  The
head runs once per sequence in a prefill (the last position's logits)
and once per decoded token.  An encoder's work over its frames
(``audio``) and a prefix of image embeddings (``vlm``) are not counted:
the count stays at or under what the program does, so that ``mfu``
cannot pass 100 %.

The sizes come from any object with ``ModelConfig``'s fields (the
program's config is data here); nothing here imports the program.
"""

from __future__ import annotations

# Dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# bf16 and fp16 on the tensor cores, float32 outside them (TF32 off).
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float32": 66.9e12}


def _attn_weights(c) -> int:
    return 2 * c.d_model * c.n_heads * c.head_dim \
        + 2 * c.d_model * c.n_kv_heads * c.head_dim


def _ssm_weights(c) -> int:
    di = c.ssm_expand * c.d_model
    heads = di // c.ssm_head_dim
    conv_dim = di + 2 * c.ssm_state
    return c.d_model * (2 * di + 2 * c.ssm_state + heads) \
        + c.ssm_conv * conv_dim + di * c.d_model


def ssm_update_flops(c) -> int:
    """The state's update per token in one SSM layer, a multiply-add per
    element of the (heads, head_dim, state) state (heads · head_dim is
    d_inner).  Its read-out, C · state, takes as many again."""
    return 2 * c.ssm_expand * c.d_model * c.ssm_state


def _glu(d: int, f: int) -> int:
    return 3 * d * f


def layer_weights(c) -> int:
    """Weights one token is multiplied by in one (decoder) layer."""
    fam, d = c.family, c.d_model
    if fam in ("dense", "vlm"):
        return _attn_weights(c) + _glu(d, c.d_ff)
    if fam == "moe":
        return (_attn_weights(c) + d * c.n_experts + c.top_k * _glu(d, c.d_ff)
                + (_glu(d, c.dense_residual_ff) if c.dense_residual_ff
                   else 0))
    if fam == "ssm":
        return _ssm_weights(c)
    if fam == "hybrid":
        return _attn_weights(c) + _ssm_weights(c) + _glu(d, c.d_ff)
    if fam == "audio":
        # self-attention, the cross-attention's query and output (its
        # keys and values are the encoder memory's, made once), the MLP
        cross = 2 * d * c.n_heads * c.head_dim
        return _attn_weights(c) + cross + _glu(d, c.d_ff)
    raise ValueError(f"no FLOP count for the {fam!r} family")


def _has_attention(c) -> bool:
    return c.family != "ssm"


def _local(c, i: int) -> bool:
    if c.attn_window is None:
        return False
    p = c.local_global_period
    return True if p is None else i % p != p - 1


def _seen(a: int, b: int, window: int | None) -> int:
    """Σ over contexts t = a..b of the positions a token at context t
    attends to: t, or at most ``window``."""
    if b < a:
        return 0
    if window is None or b <= window:
        return (a + b) * (b - a + 1) // 2
    if a > window:
        return window * (b - a + 1)
    return (a + window) * (window - a + 1) // 2 + window * (b - window)


def _span_flops(c, a: int, b: int) -> int:
    """Model FLOPs of the tokens at contexts a..b, without the head."""
    n = b - a + 1
    total = 2 * n * c.n_layers * layer_weights(c)
    if c.family in ("ssm", "hybrid"):
        total += n * c.n_layers * 2 * ssm_update_flops(c)
    if _has_attention(c):
        per = 4 * c.n_heads * c.head_dim
        for i in range(c.n_layers):
            window = c.attn_window if _local(c, i) else None
            total += per * _seen(a, b, window)
        if c.family == "audio":
            total += n * c.n_layers * per * c.n_frames
    return total


def head_flops(c) -> int:
    return 2 * c.d_model * c.vocab_size


def prefill_flops(c, prompt: int) -> int:
    """One sequence's prefill of ``prompt`` tokens (logits of the last)."""
    return _span_flops(c, 1, prompt) + head_flops(c)


def decode_flops(c, prompt: int, gen: int) -> int:
    """One sequence's ``gen`` decode steps after a prompt of ``prompt``:
    step j feeds the token at context prompt + j."""
    return _span_flops(c, prompt + 1, prompt + gen) + gen * head_flops(c)


def peak_flops(c) -> float:
    """The card's dense peak in the configuration's compute dtype."""
    if c.dtype not in PEAK_FLOPS:
        raise ValueError(f"no peak for compute dtype {c.dtype!r}")
    return PEAK_FLOPS[c.dtype]
