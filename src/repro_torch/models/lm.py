"""Causal LM of the zoo's attention families (dense, vlm) as a torch
module.

Port of ``repro/models/lm.py``'s :class:`CausalLM`.  The reference keeps
its params in a pytree with a stacked leading layer dim and scans over
it; here the params are the module's own: ``embed``, ``final_norm``,
``lm_head`` (untied configs) and an ``nn.ModuleList`` of layers, each
holding ``norm1``/``norm2`` (``norm1_post``/``norm2_post`` with
``post_block_norm``) and the ``attn`` and ``mlp`` weight dicts.  Weights
keep the reference's ``(in, out)`` orientation (``x @ w``), so
:mod:`repro_torch.models.convert` carries a reference tree across by
copies alone.  Methods have the reference's signatures without
``params``: ``init(generator)``, ``forward(tokens, prefix_embeds)``,
``prefill(tokens, max_len, prefix_embeds)``, ``decode_step(cache,
tokens)``, ``init_cache(batch, max_len)``.

Numerics follow the reference: every call first casts the float32
weights of ndim ≥ 2 to the activation dtype (the norms stay float32),
the head's float32 logits come from :func:`f32_product`, and
Gemma2's embedding scale is ``sqrt(d_model)`` rounded to the activation
dtype.  The cache is the reference's: roped k and unroped v in the
activation dtype, ``(L, B, max_len, KVH, D)``, and one scalar ``pos``.

``moe``, ``ssm`` and ``hybrid`` configs raise ``NotImplementedError``:
their modules are not ported yet.  The training loss waits for the
training slice.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.core.radic import resolve_device

from .attention import attn_decode, attn_forward, init_attn, init_kv_cache
from .config import ModelConfig
from .layers import dense_init, glu_mlp, init_glu_mlp, rmsnorm, rope

__all__ = ["CausalLM", "PORTED_FAMILIES"]

PORTED_FAMILIES = ("dense", "vlm")
_NOT_YET = ("{family} is not ported yet: its serving path is ROADMAP "
            "queue 1 item 10 (moe, ssm, hybrid, encdec serving)")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(_NOT_YET.format(family=cfg.family))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _weights(names_shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(s, dtype=dtype, device=device),
                        requires_grad=False)
        for k, s in names_shapes.items()})


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((d,), dtype=torch.float32,
                                    device=device), requires_grad=False)


class _Layer(nn.Module):
    """One block's params: norms, ``attn`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, pd = cfg.d_model, cfg.pdtype
        self.norm1 = _norm(d, device)
        self.norm2 = _norm(d, device)
        if cfg.post_block_norm:
            self.norm1_post = _norm(d, device)
            self.norm2_post = _norm(d, device)
        self.attn = _weights({"wq": (d, cfg.qdim), "wk": (d, cfg.kvdim),
                              "wv": (d, cfg.kvdim), "wo": (cfg.qdim, d)},
                             pd, device)
        self.mlp = _weights({"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                             "w_down": (cfg.d_ff, d)}, pd, device)

    def tree(self) -> dict:
        """This layer's params as the reference's per-layer dict."""
        out: dict[str, Any] = {}
        for name, p in self.named_parameters(recurse=False):
            out[name] = p
        out["attn"] = dict(self.attn.items())
        out["mlp"] = dict(self.mlp.items())
        return out


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 output, as the reference's
    ``preferred_element_type``.  A bf16 or fp16 product on the card writes
    float32 straight from its float32 accumulator (``torch.mm``'s
    ``out_dtype``), so the weights are read once and never copied; on the
    CPU, and in float32, it takes float32 operands.  Both multiply the same
    values (bf16 and fp16 are exact in float32)."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


class CausalLM(nn.Module):
    """The zoo's causal LM for ``dense`` and ``vlm`` configs, with its
    params allocated (uninitialized) on ``device`` (default ``"cuda"``:
    ``RuntimeError`` without a card; ``"meta"`` allocates nothing).  Fill
    them with :meth:`init` or :func:`repro_torch.models.convert.
    params_from_reference`."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        cfg.validate()
        _check_family(cfg)
        self.cfg = cfg
        dev = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        d, pd = cfg.d_model, cfg.pdtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, d), dtype=pd, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(_Layer(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(d, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((d, cfg.vocab_size), dtype=pd, device=dev),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CausalLM":
        """The reference's initializers, drawn from ``generator`` (on the
        module's device): truncated-normal fan-in weights, zero norms.
        Embed first, then each layer's attn and mlp, then the head."""
        cfg = self.cfg
        pd = cfg.pdtype
        self.embed.copy_(dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                    1, pd))
        for layer in self.layers:
            for p in layer.parameters(recurse=False):
                p.zero_()
            for name, w in init_attn(generator, cfg).items():
                layer.attn[name].copy_(w)
            for name, w in init_glu_mlp(generator, cfg.d_model, cfg.d_ff,
                                        pd).items():
                layer.mlp[name].copy_(w)
        self.final_norm.zero_()
        if not cfg.tie_embeddings:
            self.lm_head.copy_(dense_init(
                generator, (cfg.d_model, cfg.vocab_size), 0, pd))
        return self

    def logical_axes(self) -> dict:
        """Tree of logical-axis tuples in the reference's stacked layout
        (a leading "layers" dim on every layer param)."""
        cfg = self.cfg
        nrm = ("layers", None)
        lay: dict[str, Any] = {"norm1": nrm, "norm2": nrm}
        if cfg.post_block_norm:
            lay["norm1_post"] = nrm
            lay["norm2_post"] = nrm
        lay["attn"] = {"wq": ("layers", "embed", "qdim"),
                       "wk": ("layers", "embed", "kvdim"),
                       "wv": ("layers", "embed", "kvdim"),
                       "wo": ("layers", "qdim", "embed")}
        lay["mlp"] = {"w_gate": ("layers", "embed", "mlp"),
                      "w_up": ("layers", "embed", "mlp"),
                      "w_down": ("layers", "mlp", "embed")}
        axes = {"embed": ("vocab", "embed"), "layers": lay,
                "final_norm": (None,)}
        if not cfg.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        return axes

    def _cast(self) -> dict:
        """The params as the reference's tree (``layers`` a list), float32
        leaves of ndim ≥ 2 cast to the activation dtype."""
        ad = self.cfg.adtype

        def c(w):
            return w.to(ad) if (w.dtype == torch.float32 and w.ndim >= 2
                                ) else w
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "layers": [layer.tree() for layer in self.layers]}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        return _tree_map(c, tree)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _local_flags(self) -> np.ndarray:
        cfg = self.cfg
        return np.array([cfg.is_local_layer(i)
                         for i in range(cfg.n_layers)])

    def _block(self, lp, x, h_in, positions, is_local):
        """One block given its first norm ``h_in`` (prefill reuses it for
        the cache's k and v)."""
        a = attn_forward(lp["attn"], h_in, self.cfg, positions=positions,
                         is_local=is_local)
        return self._after_attn(lp, x, a)

    def _after_attn(self, lp, x, a):
        """The rest of a block given its attention output ``a``: the
        residual adds, the GLU MLP and Gemma2's post-norms."""
        cfg = self.cfg
        if cfg.post_block_norm:
            a = rmsnorm(a, lp["norm1_post"], cfg.norm_eps)
        x = x + a
        h = glu_mlp(lp["mlp"], rmsnorm(x, lp["norm2"], cfg.norm_eps),
                    cfg.act)
        if cfg.post_block_norm:
            h = rmsnorm(h, lp["norm2_post"], cfg.norm_eps)
        return x + h

    def _scale(self, x):
        cfg = self.cfg
        if not cfg.scale_embeddings:
            return x
        # sqrt(d_model) rounded to the activation dtype, then the multiply
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.adtype,
                                device=x.device)

    def _embed(self, params, tokens, prefix_embeds=None):
        cfg = self.cfg
        x = params["embed"][tokens].to(cfg.adtype)
        if cfg.prefix_embeds:
            assert prefix_embeds is not None, "vlm needs prefix embeds"
            x = torch.cat([prefix_embeds.to(cfg.adtype), x], dim=1)
        return self._scale(x)

    def _head(self, params, x):
        cfg = self.cfg
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"])
        logits = f32_product(x, w.to(x.dtype))
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    def _positions(self, x) -> torch.Tensor:
        B, S = x.shape[0], x.shape[1]
        return torch.arange(S, dtype=torch.int32,
                            device=x.device).expand(B, S)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def forward(self, tokens, prefix_embeds=None):
        """tokens (B,S) -> (logits (B, S(+P), V) f32, aux 0.0)."""
        cfg = self.cfg
        params = self._cast()
        x = self._embed(params, self._tokens(tokens), prefix_embeds)
        positions = self._positions(x)
        for lp, fl in zip(params["layers"], self._local_flags()):
            x = self._block(lp, x, rmsnorm(x, lp["norm1"], cfg.norm_eps),
                            positions, bool(fl))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._head(params, x), aux

    # ------------------------------------------------------------------
    # inference: prefill + decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cache: dict[str, Any] = {
            "pos": torch.zeros((), dtype=torch.int32, device=self.device)}
        cache.update(init_kv_cache(self.cfg, batch, max_len,
                                   device=self.device))
        return cache

    def cache_logical_axes(self, cache) -> dict:
        ax: dict[str, Any] = {"pos": ()}
        if "k" in cache:
            kv = ("layers", "batch", "kv_seq", None, "head_dim")
            ax["k"] = kv
            ax["v"] = kv
        if "conv" in cache:
            ax["conv"] = ("layers", "batch", None, "inner")
            ax["state"] = ("layers", "batch", "ssm_heads", None, "state")
        return ax

    def prefill(self, tokens, max_len: int, prefix_embeds=None):
        """Full-sequence forward that also fills the KV cache.

        Returns (last-position logits (B,V), cache).  The cache holds
        ``max_len`` slots; tokens fill ``[0, S)``.
        """
        cfg = self.cfg
        params = self._cast()
        x = self._embed(params, self._tokens(tokens), prefix_embeds)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(x)
        cache = self.init_cache(B, max_len)
        ck, cv = cache["k"], cache["v"]
        for i, (lp, fl) in enumerate(zip(params["layers"],
                                         self._local_flags())):
            h_in = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            x = self._block(lp, x, h_in, positions, bool(fl))
            # the cache recomputes k and v from the block's normed input
            k = (h_in @ lp["attn"]["wk"]).reshape(
                B, S, cfg.n_kv_heads, cfg.head_dim)
            v = (h_in @ lp["attn"]["wv"]).reshape(
                B, S, cfg.n_kv_heads, cfg.head_dim)
            ck[i, :, :S] = rope(k, positions, cfg.rope_theta).to(cfg.adtype)
            cv[i, :, :S] = v.to(cfg.adtype)
        logits = self._head(params, x[:, -1:, :])[:, 0]
        cache["pos"].fill_(S)
        return logits, cache

    def decode_step(self, cache, tokens):
        """tokens (B,1) -> (logits (B,V), new cache).  One step.

        With ``cfg.cache_update == "dus"`` the new cache's k and v are the
        given tensors, written in place; with ``"onehot"`` they are new
        tensors and ``cache`` is left as it was."""
        cfg = self.cfg
        params = self._cast()
        pos = cache["pos"]
        tokens = self._tokens(tokens)
        B = tokens.shape[0]
        x = self._scale(params["embed"][tokens].to(cfg.adtype))
        posb = pos.expand(B)
        in_place = cfg.cache_update == "dus"
        new_k = cache["k"] if in_place else torch.empty_like(cache["k"])
        new_v = cache["v"] if in_place else torch.empty_like(cache["v"])
        for i, (lp, fl) in enumerate(zip(params["layers"],
                                         self._local_flags())):
            h_in = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            a, k, v = attn_decode(lp["attn"], h_in, cache["k"][i],
                                  cache["v"][i], posb, cfg,
                                  is_local=bool(fl))
            if not in_place:
                new_k[i] = k
                new_v[i] = v
            x = self._after_attn(lp, x, a)
        logits = self._head(params, x)[:, 0]
        return logits, {"k": new_k, "v": new_v, "pos": pos + 1}
