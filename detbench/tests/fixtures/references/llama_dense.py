"""A plain Llama-style dense decoder in float32: RMSNorm, rotary
embeddings (rotate-half), grouped-query causal attention, a SwiGLU MLP
and an untied head, one full forward over the whole sequence with no
cache and no batching tricks.  Nothing of the program is imported.

``forward(params, cfg, tokens)``: ``params`` maps the port's parameter
names (``embed``, ``layers.<i>.norm1``, ``layers.<i>.attn.wq``, ...,
``final_norm``, ``lm_head``) to tensors in any float dtype, matrices
``(in, out)`` as ``x @ w`` takes them; ``cfg`` is the configuration
file (the published config's keys); ``tokens`` (B, S) → float32 logits
(B, S, V).  One departure from the published description: a norm's
weight is stored as its offset from 1 (the port's layout), so the
scale is ``1 + w``.  Each weight is cast to float32 where it is used,
so the float32 copies live one layer at a time.
"""

import torch


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def _rope(x, theta):
    """x (B, S, H, D), rotated by position (the angles in float64)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freq
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(params, cfg, tokens):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def w(name):
        return params[name].float()

    B, S = tokens.shape
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    KV = cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or d // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = params["embed"][tokens].float()
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        h = _rmsnorm(x, params[pre + "norm1"], eps)
        q = _rope((h @ w(pre + "attn.wq")).view(B, S, H, D), theta)
        k = _rope((h @ w(pre + "attn.wk")).view(B, S, KV, D), theta)
        v = (h @ w(pre + "attn.wv")).view(B, S, KV, D)
        # query head j reads key/value head j // (H / KV)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q, k) * D ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        del s
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, H * D)
        del p
        x = x + o @ w(pre + "attn.wo")
        h = _rmsnorm(x, params[pre + "norm2"], eps)
        g = torch.nn.functional.silu(h @ w(pre + "mlp.w_gate"))
        x = x + (g * (h @ w(pre + "mlp.w_up"))) @ w(pre + "mlp.w_down")
    x = _rmsnorm(x, params["final_norm"], eps)
    head = w("embed").T if cfg.get("tie_word_embeddings") else w("lm_head")
    return x @ head
