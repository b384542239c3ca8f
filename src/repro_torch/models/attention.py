"""Grouped-query attention with sliding-window / softcap options and a
KV-cache decode path.

Port of ``repro/models/attention.py``: functions over explicit param
mappings, one layer at a time, in the reference's jnp math.  Its
numerics carry over:

* the score contractions take float32 operands, since the reference asks
  for a float32 result (``preferred_element_type``) and a bf16 matmul in
  torch rounds its output to bf16; the softmax weights are cast to
  ``v``'s dtype before the P·V product;
* masks are large but finite (``NEG_INF``), so a fully masked row gives
  uniform weights, not NaN;
* the sliding window is ``rel < window`` in the forward and
  ``tpos > pos - window`` in decode.

This is not ``scaled_dot_product_attention``, whose masking and
accumulation differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Leaf, materialize, rope

__all__ = ["init_attn", "attn_spec", "attn_forward", "attn_decode",
           "init_kv_cache"]

NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaN rows on fully-masked
PAD_POS = -(10 ** 9)  # position of the chunked path's padding keys


def attn_spec(cfg: ModelConfig) -> dict:
    d, pd = cfg.d_model, cfg.pdtype
    return {"wq": Leaf((d, cfg.qdim), pd, 0),
            "wk": Leaf((d, cfg.kvdim), pd, 0),
            "wv": Leaf((d, cfg.kvdim), pd, 0),
            "wo": Leaf((cfg.qdim, d), pd, 0)}


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              cross: bool = False) -> dict:
    return materialize(attn_spec(cfg), generator)


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _softcap(s: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        s = c * torch.tanh(s / c)
    return s


def _gqa_scores(q, k, cfg: ModelConfig):
    """q (B,S,H,D), k (B,T,KVH,D) -> scores (B,KVH,G,S,T) in f32."""
    g = cfg.n_heads // cfg.n_kv_heads
    B, S = q.shape[0], q.shape[1]
    qg = q.reshape(B, S, cfg.n_kv_heads, g, cfg.head_dim)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return _softcap(s * (cfg.head_dim ** -0.5), cfg)


def _softcap_softmax(scores, mask):
    scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def _attn_chunked(q, k, v, cfg: ModelConfig, positions, kv_pos, is_local,
                  causal: bool):
    """KV-chunked online-softmax attention (flash-style in plain torch).

    Walks KV chunks with a running (max, denominator, accumulator), so the
    largest live score buffer is (B,KVH,G,S,chunk) instead of (…,S,T).
    The running stats are float32; the accumulator is in ``v``'s dtype,
    as in the reference.
    """
    B, S = q.shape[0], q.shape[1]
    T = k.shape[1]
    g = cfg.n_heads // cfg.n_kv_heads
    K, D = cfg.n_kv_heads, cfg.head_dim
    C = min(cfg.attn_chunk, T)
    pad = (-T) % C
    if pad:
        zk = torch.zeros((B, pad, *k.shape[2:]), dtype=k.dtype,
                         device=k.device)
        k = torch.cat([k, zk], dim=1)
        v = torch.cat([v, torch.zeros_like(zk, dtype=v.dtype)], dim=1)
        kv_pos = torch.cat(
            [kv_pos, torch.full((B, pad), PAD_POS, dtype=kv_pos.dtype,
                                device=kv_pos.device)], dim=1)
    nc = (T + pad) // C
    qg = q.reshape(B, S, K, g, D).float()
    kc = k.reshape(B, nc, C, K, D)
    vc = v.reshape(B, nc, C, K, D)
    pc = kv_pos.reshape(B, nc, C)
    scale = D ** -0.5

    m_run = torch.full((B, K, g, S), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, K, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, g, S, D), dtype=v.dtype, device=q.device)
    for c in range(nc):
        kb, vb, pb = kc[:, c], vc[:, c], pc[:, c]  # (B,C,K,D) (B,C,K,D) (B,C)
        s = _softcap(torch.einsum("bskgd,btkd->bkgst", qg, kb.float())
                     * scale, cfg)
        rel = positions[:, :, None] - pb[:, None, :]       # (B,S,C)
        mask = pb[:, None, :] >= 0
        if causal:
            mask = mask & (rel >= 0)
        if cfg.attn_window is not None and is_local:
            mask = mask & (rel < cfg.attn_window)
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None].to(acc.dtype) + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(vb.dtype), vb)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None].to(acc.dtype)
    return out.movedim(3, 1).reshape(B, S, cfg.qdim)  # (B,S,K,G,D)


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, is_local: bool,
                 kv: torch.Tensor | None = None,
                 kv_positions: torch.Tensor | None = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill / encoder / cross).

    ``kv``: source sequence for cross-attention (defaults to ``x``).
    ``is_local``: applies the sliding-window mask (size
    ``cfg.attn_window``) when true, from ``cfg.is_local_layer``.
    """
    src = x if kv is None else kv
    kv_pos = positions if kv_positions is None else kv_positions
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(src @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(src @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    if kv is None:  # self-attention gets RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_pos, cfg.rope_theta)
    if cfg.attn_chunk:
        out = _attn_chunked(q, k, v, cfg, positions, kv_pos, is_local,
                            causal)
        return out @ p["wo"]
    scores = _gqa_scores(q, k, cfg)  # (B,KVH,G,S,T)
    rel = positions[:, :, None] - kv_pos[:, None, :]  # (B,S,T)
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask = mask & (rel >= 0)
        if cfg.attn_window is not None and is_local:
            mask = mask & (rel < cfg.attn_window)
    w = _softcap_softmax(scores, mask[:, None, None, :, :])
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    out = out.reshape(*x.shape[:-1], cfg.qdim)
    return out @ p["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int | None = None, dtype=None, *,
                  device="cuda") -> dict:
    """Stacked-over-layers KV cache (L, B, T, KVH, D) on ``device``."""
    L = n_layers if n_layers is not None else cfg.n_layers
    dtype = dtype or cfg.adtype
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x: torch.Tensor, cache_k, cache_v, pos,
                cfg: ModelConfig, *, is_local: bool,
                kv_ready: torch.Tensor | None = None, write: bool = True):
    """One-token decode. x (B,1,D); cache_k/v (B,T,KVH,D); pos (B,) int32.

    Returns (out (B,1,D), new_k, new_v).  ``kv_ready`` optionally marks
    cache slots as valid; ``write=False`` reads a static cache without
    RoPE or update (cross-attention memories).

    ``cfg.cache_update == "onehot"`` builds new cache tensors (the
    reference's (B,T) one-hot blend, a row's own position each);
    ``"dus"`` writes the token at ``pos[0]`` (one decode position for the
    whole batch, as in the reference) into the given tensors in place,
    the counterpart of XLA's in-place ``dynamic_update_slice``.
    """
    B = x.shape[0]
    T = cache_k.shape[1]
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    if write:
        k_new = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
        v_new = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
        q = rope(q, pos[:, None], cfg.rope_theta)
        k_new = rope(k_new, pos[:, None], cfg.rope_theta)
        if cfg.cache_update == "dus":
            # uniform decode position (our serving model): one slice write
            # instead of a (B,T) one-hot blend — O(B·KVH·D) bytes written
            # vs O(B·T·KVH·D) touched; the start clamps as XLA's does
            at = pos[:1].long().clamp(0, T - 1)
            cache_k.index_copy_(1, at, k_new.to(cache_k.dtype))
            cache_v.index_copy_(1, at, v_new.to(cache_v.dtype))
        else:
            # scatter the new token into the cache at pos (per batch row)
            oh = F.one_hot(pos.long(), T).to(cache_k.dtype)  # (B,T)
            cache_k = cache_k * (1 - oh)[:, :, None, None] + \
                oh[:, :, None, None] * k_new.to(cache_k.dtype)
            cache_v = cache_v * (1 - oh)[:, :, None, None] + \
                oh[:, :, None, None] * v_new.to(cache_v.dtype)
    scores = _gqa_scores(q, cache_k, cfg)  # (B,KVH,G,1,T)
    tpos = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    mask = tpos <= pos[:, None]
    if kv_ready is not None:
        mask = mask & kv_ready
    if cfg.attn_window is not None and is_local:
        mask = mask & (tpos > (pos[:, None] - cfg.attn_window))
    w = _softcap_softmax(scores, mask[:, None, None, None, :])
    out = torch.einsum("bkgst,btkd->bskgd", w.to(cache_v.dtype), cache_v)
    out = out.reshape(B, 1, cfg.qdim)
    return out @ p["wo"], cache_k, cache_v
