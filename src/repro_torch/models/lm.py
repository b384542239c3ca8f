"""Causal LM over the zoo's decoder families (dense, vlm, moe, ssm,
hybrid) as a torch module.

Port of ``repro/models/lm.py``'s :class:`CausalLM`.  The reference keeps
its params in a pytree with a stacked leading layer dim and scans over
it; here the params are the module's own: ``embed``, ``final_norm``,
``lm_head`` (untied configs) and an ``nn.ModuleList`` of layers, each a
:class:`~repro_torch.models.layers.ParamTree` of the reference's
per-layer dict for the family (``norm1``/``norm2`` and ``attn`` with
``mlp`` or ``moe`` (``moe.dense`` for arctic); ``norm1`` and ``ssm``;
``mix.attn``, ``mix.ssm``, ``mix.gate`` and ``mlp`` for hybrid).
Weights keep the reference's ``(in, out)`` orientation (``x @ w``), so
:mod:`repro_torch.models.convert` carries a reference tree across by
copies alone.  Methods have the reference's signatures without
``params``: ``init(generator)``, ``forward(tokens, prefix_embeds)``,
``prefill(tokens, max_len, prefix_embeds)``, ``decode_step(cache,
tokens)``, ``init_cache(batch, max_len)``.

Numerics follow the reference: every call first casts the float32
weights of ndim ≥ 2 to the activation dtype (the MoE router among them;
the norms, the SSM's vectors and the hybrid gate, of ndim 1, stay
float32), the head's float32 logits come from :func:`f32_product`, and
Gemma2's embedding scale is ``sqrt(d_model)`` rounded to the activation
dtype.
The cache is the reference's: roped k and unroped v in the activation
dtype, ``(L, B, max_len, KVH, D)``; the SSM's conv tail ``(L, B, K-1,
conv_dim)`` and state ``(L, B, H, P, N)``; one scalar ``pos``.
``forward`` returns the MoE aux loss summed over layers.

Training: :meth:`CausalLM.loss` is the reference's next-token CE (labels
``-1`` ignored, vlm's prefix positions cut off) plus ``0.01 * aux``; with
``cfg.loss_chunk`` the head product and the CE run a sequence chunk at a
time (:meth:`CausalLM._ce_chunked`), each chunk recomputed in the
backward, so the ``(B, S, V)`` logits are never held.  With
``cfg.remat`` each block runs under :func:`remat` (recomputed in the
backward; ``remat_policy="dots"`` keeps its products).  Both apply only
while autograd records: serving runs under ``torch.inference_mode()``
and is unchanged.  The embedding is ``F.embedding``, whose backward on
the card sorts the token ids and sums each id's rows without atomics,
and the head's narrow-float product has its own backward
(:func:`f32_product`).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.radic import resolve_device

from .attention import (attn_decode, attn_forward, attn_spec,
                        init_kv_cache)
from .config import ModelConfig
from .hybrid import _mix, hybrid_decode, hybrid_forward, hybrid_spec
from .layers import Leaf, ParamTree, draw, glu_mlp, glu_spec, rmsnorm, rope
from .moe import moe_forward, moe_spec
from .ssm import init_ssm_cache, ssm_decode, ssm_forward, ssm_spec

__all__ = ["CausalLM", "PORTED_FAMILIES", "f32_product", "remat",
           "cross_entropy"]

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_tree(tree, adtype: torch.dtype):
    """The reference's ``_cast``: float32 leaves of ndim ≥ 2 to the
    activation dtype, the rest as they are."""
    def c(w):
        return w.to(adtype) if (w.dtype == torch.float32 and w.ndim >= 2
                                ) else w
    return _tree_map(c, tree)


def _norm_leaf(d: int) -> Leaf:
    return Leaf((d,), torch.float32)


def layer_spec(cfg: ModelConfig) -> dict:
    """One layer's params for the family, as the reference's
    ``_init_layer`` lays them out (and draws them, in this order)."""
    fam, d, pd = cfg.family, cfg.d_model, cfg.pdtype
    p: dict[str, Any] = {}
    if fam in ("dense", "vlm", "moe", "hybrid"):
        p["norm1"] = _norm_leaf(d)
        p["norm2"] = _norm_leaf(d)
        if cfg.post_block_norm:
            p["norm1_post"] = _norm_leaf(d)
            p["norm2_post"] = _norm_leaf(d)
    if fam in ("dense", "vlm"):
        p["attn"] = attn_spec(cfg)
        p["mlp"] = glu_spec(d, cfg.d_ff, pd)
    elif fam == "moe":
        p["attn"] = attn_spec(cfg)
        p["moe"] = moe_spec(cfg)
    elif fam == "ssm":
        p["norm1"] = _norm_leaf(d)
        p["ssm"] = ssm_spec(cfg)
    elif fam == "hybrid":
        p["mix"] = hybrid_spec(cfg)
        p["mlp"] = glu_spec(d, cfg.d_ff, pd)
    else:
        raise ValueError(f"{fam} is not a CausalLM family (audio is "
                         "EncDecLM's)")
    return p


def attn_axes() -> dict:
    return {"wq": ("layers", "embed", "qdim"),
            "wk": ("layers", "embed", "kvdim"),
            "wv": ("layers", "embed", "kvdim"),
            "wo": ("layers", "qdim", "embed")}


def mlp_axes() -> dict:
    return {"w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed")}


def _ssm_axes() -> dict:
    return {"in_proj": ("layers", "embed", "inner"),
            "conv_w": ("layers", "conv", None),
            "conv_b": ("layers", None),
            "A_log": ("layers", None),
            "D": ("layers", None),
            "dt_bias": ("layers", None),
            "norm_w": ("layers", "inner"),
            "out_proj": ("layers", "inner", "embed")}


class _NarrowF32Product(torch.autograd.Function):
    """``x @ w`` of bf16 or fp16 2-d operands written in float32 by
    ``torch.mm``'s ``out_dtype``.  Its backward is what jax transposes a
    ``preferred_element_type=float32`` product into: the float32
    cotangent cast to the operands' dtype, then products in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = x.T @ g if ctx.needs_input_grad[1] else None
        return gx, gw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 output, as the reference's
    ``preferred_element_type``.  A bf16 or fp16 product on the card writes
    float32 straight from its float32 accumulator (``torch.mm``'s
    ``out_dtype``), so the weights are read once and never copied; on the
    CPU, and in float32, it takes float32 operands.  Both multiply the same
    values (bf16 and fp16 are exact in float32).  The card's narrow
    product runs through :class:`_NarrowF32Product`, which also carries
    its backward."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        out = _NarrowF32Product.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


# the products jax's ``dots_with_no_batch_dims_saveable`` keeps: ``x @ w``
# of an activation and a weight folds to a 2-d ``mm``; attention's
# einsums, with batch dims, run as ``bmm`` and are recomputed
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, *args, policy: str | None = None):
    """``fn(*args)``, recomputed in the backward when ``cfg.remat`` is set
    and autograd records (``torch.utils.checkpoint``, non-reentrant): the
    reference's ``jax.checkpoint`` of a block.  ``policy`` (default
    ``cfg.remat_policy``): ``"nothing"`` saves only the inputs,
    ``"dots"`` also the products without batch dims."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    policy = cfg.remat_policy if policy is None else policy
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=(
            functools.partial(create_selective_checkpoint_contexts,
                              _save_products)))
    return checkpoint(fn, *args, use_reentrant=False)


def cross_entropy(logits: torch.Tensor, tgt: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of ``lse - logits[tgt]`` over the kept positions, their
    count), both float32: the reference's masked CE before its division.
    Labels below 0 are ignored.  ``F.cross_entropy``'s backward writes one
    entry a row, with no scatter-add."""
    tgt = tgt.masked_fill(tgt < 0, -1)
    s = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                        tgt.reshape(-1), ignore_index=-1, reduction="sum")
    return s, (tgt >= 0).sum().to(torch.float32)


def model_device(device) -> torch.device:
    """``"meta"`` as it is (shapes without memory), else the card unless
    the caller asks for another device."""
    return torch.device(device) if str(device) == "meta" \
        else resolve_device(device)


class CausalLM(nn.Module):
    """The zoo's causal LM for ``dense``, ``vlm``, ``moe``, ``ssm`` and
    ``hybrid`` configs, with its params allocated (uninitialized) on
    ``device`` (default ``"cuda"``: ``RuntimeError`` without a card;
    ``"meta"`` allocates nothing).  Fill them with :meth:`init` or
    :func:`repro_torch.models.convert.params_from_reference`."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        cfg.validate()
        spec = layer_spec(cfg)
        self.cfg = cfg
        dev = model_device(device)
        d, pd = cfg.d_model, cfg.pdtype
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, d), dtype=pd, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(spec, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(
            torch.zeros((d,), dtype=torch.float32, device=dev),
            requires_grad=False)
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
        module's device): truncated-normal fan-in weights, zero norms, the
        SSM's constants.  Embed first, then each layer's leaves in the
        reference's order, then the head."""
        cfg = self.cfg
        pd = cfg.pdtype
        draw(Leaf((cfg.vocab_size, cfg.d_model), pd, 1), generator,
             out=self.embed)
        for layer in self.layers:
            layer.init(generator)
        self.final_norm.zero_()
        if not cfg.tie_embeddings:
            draw(Leaf((cfg.d_model, cfg.vocab_size), pd, 0), generator,
                 out=self.lm_head)
        return self

    def logical_axes(self) -> dict:
        """Tree of logical-axis tuples in the reference's stacked layout
        (a leading "layers" dim on every layer param)."""
        cfg = self.cfg
        nrm = ("layers", None)
        lay: dict[str, Any] = {}
        if cfg.family in ("dense", "vlm", "moe", "hybrid"):
            lay["norm1"] = nrm
            lay["norm2"] = nrm
            if cfg.post_block_norm:
                lay["norm1_post"] = nrm
                lay["norm2_post"] = nrm
        if cfg.family in ("dense", "vlm"):
            lay["attn"] = attn_axes()
            lay["mlp"] = mlp_axes()
        elif cfg.family == "moe":
            lay["attn"] = attn_axes()
            moe_ax = {"router": ("layers", "embed", None),
                      "w_gate": ("layers", "experts", "embed", "mlp"),
                      "w_up": ("layers", "experts", "embed", "mlp"),
                      "w_down": ("layers", "experts", "mlp", "embed")}
            if cfg.dense_residual_ff:
                moe_ax["dense"] = mlp_axes()
            lay["moe"] = moe_ax
        elif cfg.family == "ssm":
            lay["norm1"] = nrm
            lay["ssm"] = _ssm_axes()
        elif cfg.family == "hybrid":
            lay["mix"] = {"attn": attn_axes(), "ssm": _ssm_axes(),
                          "gate": ("layers", None)}
            lay["mlp"] = mlp_axes()
        axes = {"embed": ("vocab", "embed"), "layers": lay,
                "final_norm": (None,)}
        if not cfg.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        return axes

    def _cast(self) -> dict:
        """The params as the reference's tree (``layers`` a list), float32
        leaves of ndim ≥ 2 cast to the activation dtype."""
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "layers": [layer.tree() for layer in self.layers]}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        return cast_tree(tree, self.cfg.adtype)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _local_flags(self) -> np.ndarray:
        cfg = self.cfg
        return np.array([cfg.is_local_layer(i)
                         for i in range(cfg.n_layers)])

    def _block(self, lp, x, positions, is_local):
        """One block of the forward: (x, the layer's MoE aux loss)."""
        cfg = self.cfg
        h_in = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if cfg.family == "ssm":
            return x + ssm_forward(lp["ssm"], h_in, cfg), None
        if cfg.family == "hybrid":
            x = x + hybrid_forward(lp["mix"], h_in, cfg, positions=positions,
                                   is_local=is_local)
            return self._mlp(lp, x), None
        a = attn_forward(lp["attn"], h_in, cfg, positions=positions,
                         is_local=is_local)
        return self._after_attn(lp, x, a)

    def _mlp(self, lp, x):
        """The hybrid block's GLU MLP and its residual add."""
        cfg = self.cfg
        return x + glu_mlp(lp["mlp"], rmsnorm(x, lp["norm2"], cfg.norm_eps),
                           cfg.act)

    def _after_attn(self, lp, x, a):
        """The rest of an attention block given its attention output
        ``a``: the residual adds, the GLU MLP or the MoE (with its aux
        loss; None without) and Gemma2's post-norms."""
        cfg = self.cfg
        if cfg.post_block_norm:
            a = rmsnorm(a, lp["norm1_post"], cfg.norm_eps)
        x = x + a
        h_in = rmsnorm(x, lp["norm2"], cfg.norm_eps)
        aux = None
        if cfg.family == "moe":
            h, aux = moe_forward(lp["moe"], h_in, cfg)
        else:
            h = glu_mlp(lp["mlp"], h_in, cfg.act)
        if cfg.post_block_norm:
            h = rmsnorm(h, lp["norm2_post"], cfg.norm_eps)
        return x + h, aux

    def _scale(self, x):
        cfg = self.cfg
        if not cfg.scale_embeddings:
            return x
        # sqrt(d_model) rounded to the activation dtype, then the multiply
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.adtype,
                                device=x.device)

    def _embed(self, params, tokens, prefix_embeds=None):
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"]).to(cfg.adtype)
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

    def _trunk(self, tokens, prefix_embeds=None):
        """(the cast params, the last block's output, the MoE aux loss
        summed over layers), each block under :func:`remat`."""
        params = self._cast()
        x = self._embed(params, self._tokens(tokens), prefix_embeds)
        positions = self._positions(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, fl in zip(params["layers"], self._local_flags()):
            x, a = remat(self.cfg, self._block, lp, x, positions, bool(fl))
            if a is not None:
                aux = aux + a
        return params, x, aux

    def forward(self, tokens, prefix_embeds=None):
        """tokens (B,S) -> (logits (B, S(+P), V) f32, aux): ``aux`` the
        MoE load-balancing loss summed over layers (0.0 without MoE)."""
        params, x, aux = self._trunk(tokens, prefix_embeds)
        return self._head(params, x), aux

    def loss(self, batch) -> torch.Tensor:
        """batch: tokens (B,S), labels (B,S) int (-1 = ignore) [+
        prefix_embeds (B,P,D)].  Next-token CE + 0.01 * the MoE aux loss,
        a float32 0-d tensor.

        With ``cfg.loss_chunk > 0`` the (B,S,V) logits are never held:
        the head product and the CE run per sequence chunk
        (:meth:`_ce_chunked`)."""
        cfg = self.cfg
        labels = self._tokens(batch["labels"])
        if cfg.loss_chunk:
            params, x, aux = self._trunk(batch["tokens"],
                                         batch.get("prefix_embeds"))
            if cfg.prefix_embeds:
                x = x[:, x.shape[1] - labels.shape[1]:]
            x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
            ce = self._ce_chunked(params, x[:, :-1], labels[:, 1:])
            return ce + 0.01 * aux
        logits, aux = self.forward(batch["tokens"],
                                   batch.get("prefix_embeds"))
        if cfg.prefix_embeds:  # prefix positions carry no labels
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        s, n = cross_entropy(logits[:, :-1], labels[:, 1:])
        return s / torch.clamp(n, min=1.0) + 0.01 * aux

    def _ce_chunk(self, hq, tq, w):
        """(CE sum, kept count) of one chunk: its logits by the head's
        ``f32_product`` and softcap."""
        logits = f32_product(hq, w)
        if self.cfg.final_logit_softcap:
            c = self.cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        return cross_entropy(logits, tq)

    def _ce_chunked(self, params, h, tgt):
        """CE over seq chunks of ``Q = min(loss_chunk, T)``; h (B,T,D) the
        normed pre-head hidden, tgt (B,T).  The sequence is padded to a
        multiple of Q with label -1; each chunk's logits are recomputed in
        the backward (:func:`torch.utils.checkpoint.checkpoint`)."""
        cfg = self.cfg
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"]).to(h.dtype)
        B, T, D = h.shape
        Q = min(cfg.loss_chunk, T)
        pad = (-T) % Q
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            tgt = F.pad(tgt, (0, pad), value=-1)
        s = torch.zeros((), dtype=torch.float32, device=h.device)
        n = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(0, T + pad, Q):
            hq, tq = h[:, c:c + Q], tgt[:, c:c + Q]
            if torch.is_grad_enabled():
                cs, cn = checkpoint(self._ce_chunk, hq, tq, w,
                                    use_reentrant=False)
            else:
                cs, cn = self._ce_chunk(hq, tq, w)
            s, n = s + cs, n + cn
        return s / torch.clamp(n, min=1.0)

    # ------------------------------------------------------------------
    # inference: prefill + decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        cache: dict[str, Any] = {
            "pos": torch.zeros((), dtype=torch.int32, device=self.device)}
        if cfg.family != "ssm":
            cache.update(init_kv_cache(cfg, batch, max_len,
                                       device=self.device))
        if cfg.family in ("ssm", "hybrid"):
            cache.update(init_ssm_cache(cfg, batch, device=self.device))
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
        """Full-sequence forward that also fills the KV/SSM caches.

        Returns (last-position logits (B,V), cache).  The cache holds
        ``max_len`` slots; tokens fill ``[0, S)``.
        """
        cfg = self.cfg
        params = self._cast()
        x = self._embed(params, self._tokens(tokens), prefix_embeds)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(x)
        cache = self.init_cache(B, max_len)
        for i, (lp, fl) in enumerate(zip(params["layers"],
                                         self._local_flags())):
            h_in = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            if cfg.family == "ssm":
                h, st = ssm_forward(lp["ssm"], h_in, cfg, return_state=True)
                x = x + h
            elif cfg.family == "hybrid":
                ap = lp["mix"]["attn"]
                a = attn_forward(ap, h_in, cfg, positions=positions,
                                 is_local=bool(fl))
                s, st = ssm_forward(lp["mix"]["ssm"], h_in, cfg,
                                    return_state=True)
                x = self._mlp(lp, x + _mix(lp["mix"], a, s))
            else:
                ap = lp["attn"]
                a = attn_forward(ap, h_in, cfg, positions=positions,
                                 is_local=bool(fl))
                x, _ = self._after_attn(lp, x, a)
            if cfg.family != "ssm":
                # the cache recomputes k and v from the block's normed input
                k = (h_in @ ap["wk"]).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
                v = (h_in @ ap["wv"]).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
                cache["k"][i, :, :S] = rope(k, positions,
                                            cfg.rope_theta).to(cfg.adtype)
                cache["v"][i, :, :S] = v.to(cfg.adtype)
            if cfg.family in ("ssm", "hybrid"):
                cache["conv"][i] = st["conv"]
                cache["state"][i] = st["state"]
        logits = self._head(params, x[:, -1:, :])[:, 0]
        cache["pos"].fill_(S)
        return logits, cache

    def decode_step(self, cache, tokens):
        """tokens (B,1) -> (logits (B,V), new cache).  One step.

        With ``cfg.cache_update == "dus"`` the new cache's k and v are the
        given tensors, written in place; with ``"onehot"`` they are new
        tensors.  The SSM's conv tail and state are always new tensors;
        ``cache`` keeps its own."""
        cfg = self.cfg
        params = self._cast()
        pos = cache["pos"]
        tokens = self._tokens(tokens)
        B = tokens.shape[0]
        x = self._scale(F.embedding(tokens, params["embed"]).to(cfg.adtype))
        posb = pos.expand(B)
        in_place = cfg.cache_update == "dus"
        new = {name: t if (in_place and name in ("k", "v"))
               else torch.empty_like(t)
               for name, t in cache.items() if name != "pos"}
        for i, (lp, fl) in enumerate(zip(params["layers"],
                                         self._local_flags())):
            lc = {name: t[i] for name, t in cache.items() if name != "pos"}
            h_in = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            if cfg.family == "ssm":
                h, conv, state = ssm_decode(lp["ssm"], h_in, lc["conv"],
                                            lc["state"], cfg)
                x = x + h
                out = {"conv": conv, "state": state}
            elif cfg.family == "hybrid":
                y, out = hybrid_decode(lp["mix"], h_in, lc, posb, cfg,
                                       is_local=bool(fl))
                x = self._mlp(lp, x + y)
            else:
                a, k, v = attn_decode(lp["attn"], h_in, lc["k"], lc["v"],
                                      posb, cfg, is_local=bool(fl))
                x, _ = self._after_attn(lp, x, a)
                out = {"k": k, "v": v}
            for name, t in out.items():
                if not (in_place and name in ("k", "v")):
                    new[name][i] = t
        logits = self._head(params, x)[:, 0]
        new["pos"] = pos + 1
        return logits, new
