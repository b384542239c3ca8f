"""Encoder–decoder backbone (Whisper-style) as a torch module.  The
conv/mel frontend is a STUB, as in the reference: precomputed frame
embeddings (B, n_frames, d_model) go straight into the encoder.

Port of ``repro/models/encdec.py``'s :class:`EncDecLM`: params
``embed``, ``enc_layers`` and ``dec_layers`` (``nn.ModuleList``\\ s of
:class:`~repro_torch.models.layers.ParamTree`, the reference's per-layer
dicts), ``enc_norm``, ``final_norm`` and ``lm_head``; methods with the
reference's signatures without ``params``.  The cache is the
reference's: self-attention ``k``/``v`` over ``max_len`` and the cross
memories ``ck``/``cv`` over ``n_frames``, filled once by
:meth:`warm_cross_cache` and read by each decode step with
``kv_ready`` all true and ``write=False`` at position ``n_frames - 1``.
The training loss waits for the training slice.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .attention import attn_decode, attn_forward, attn_spec, init_kv_cache
from .config import ModelConfig
from .layers import Leaf, ParamTree, draw, glu_mlp, glu_spec, rmsnorm
from .lm import attn_axes, cast_tree, f32_product, mlp_axes, model_device

__all__ = ["EncDecLM"]


def _enc_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"attn": attn_spec(cfg), "mlp": glu_spec(d, cfg.d_ff, cfg.pdtype),
            "norm1": Leaf((d,), torch.float32),
            "norm2": Leaf((d,), torch.float32)}


def _dec_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"attn": attn_spec(cfg), "cross": attn_spec(cfg),
            "mlp": glu_spec(d, cfg.d_ff, cfg.pdtype),
            "norm1": Leaf((d,), torch.float32),
            "norm2": Leaf((d,), torch.float32),
            "norm3": Leaf((d,), torch.float32)}


class EncDecLM(nn.Module):
    """Whisper-medium-shaped backbone: bidirectional encoder over frame
    embeddings; causal decoder with cross-attention.  Params allocated
    (uninitialized) on ``device`` (default ``"cuda"``: ``RuntimeError``
    without a card; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dev = model_device(device)
        d, pd = cfg.d_model, cfg.pdtype

        def param(shape, dtype=pd):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.embed = param((cfg.vocab_size, d))
        self.enc_layers = nn.ModuleList(ParamTree(_enc_spec(cfg), dev)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(ParamTree(_dec_spec(cfg), dev)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = param((d,), torch.float32)
        self.final_norm = param((d,), torch.float32)
        self.lm_head = param((d, cfg.vocab_size))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ---------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """The reference's initializers from ``generator``: the embed,
        the encoder's layers, the decoder's, then the head; zero norms."""
        cfg = self.cfg
        draw(Leaf((cfg.vocab_size, cfg.d_model), cfg.pdtype, 1), generator,
             out=self.embed)
        for layer in [*self.enc_layers, *self.dec_layers]:
            layer.init(generator)
        self.enc_norm.zero_()
        self.final_norm.zero_()
        draw(Leaf((cfg.d_model, cfg.vocab_size), cfg.pdtype, 0), generator,
             out=self.lm_head)
        return self

    def logical_axes(self) -> dict:
        nrm = ("layers", None)
        enc = {"attn": attn_axes(), "mlp": mlp_axes(), "norm1": nrm,
               "norm2": nrm}
        dec = {"attn": attn_axes(), "cross": attn_axes(), "mlp": mlp_axes(),
               "norm1": nrm, "norm2": nrm, "norm3": nrm}
        return {"embed": ("vocab", "embed"), "enc_layers": enc,
                "dec_layers": dec, "enc_norm": (None,),
                "final_norm": (None,), "lm_head": ("embed", "vocab")}

    def _cast(self) -> dict:
        tree = {"embed": self.embed, "enc_norm": self.enc_norm,
                "final_norm": self.final_norm, "lm_head": self.lm_head,
                "enc_layers": [lay.tree() for lay in self.enc_layers],
                "dec_layers": [lay.tree() for lay in self.dec_layers]}
        return cast_tree(tree, self.cfg.adtype)

    def _positions(self, B: int, T: int) -> torch.Tensor:
        return torch.arange(T, dtype=torch.int32,
                            device=self.device).expand(B, T)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _head(self, params, x):
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return f32_product(x, params["lm_head"].to(x.dtype))

    # -- encoder --------------------------------------------------------
    def _encode(self, params, frame_embeds):
        cfg = self.cfg
        x = torch.as_tensor(frame_embeds, device=self.device).to(cfg.adtype)
        pos = self._positions(x.shape[0], x.shape[1])
        for lp in params["enc_layers"]:
            x = x + attn_forward(lp["attn"], rmsnorm(x, lp["norm1"],
                                                     cfg.norm_eps), cfg,
                                 positions=pos, is_local=False, causal=False)
            x = x + glu_mlp(lp["mlp"], rmsnorm(x, lp["norm2"], cfg.norm_eps),
                            cfg.act)
        return rmsnorm(x, params["enc_norm"], cfg.norm_eps)

    def encode(self, frame_embeds):
        """frame_embeds (B, T, D) -> the encoder memory (B, T, D)."""
        return self._encode(self._cast(), frame_embeds)

    # -- decoder (teacher-forced / prefill-style) ------------------------
    def forward(self, tokens, frame_embeds):
        """tokens (B,S), frames (B,T,D) -> (logits (B,S,V) f32, 0.0)."""
        cfg = self.cfg
        params = self._cast()
        memory = self._encode(params, frame_embeds)
        tokens = self._tokens(tokens)
        x = params["embed"][tokens].to(cfg.adtype)
        B, S = tokens.shape
        pos = self._positions(B, S)
        mpos = self._positions(B, memory.shape[1])
        for lp in params["dec_layers"]:
            x = x + attn_forward(lp["attn"], rmsnorm(x, lp["norm1"],
                                                     cfg.norm_eps), cfg,
                                 positions=pos, is_local=False)
            x = x + attn_forward(lp["cross"], rmsnorm(x, lp["norm2"],
                                                      cfg.norm_eps), cfg,
                                 positions=pos, is_local=False, kv=memory,
                                 kv_positions=mpos, causal=False)
            x = x + glu_mlp(lp["mlp"], rmsnorm(x, lp["norm3"], cfg.norm_eps),
                            cfg.act)
        return self._head(params, x), \
            torch.zeros((), dtype=torch.float32, device=x.device)

    # -- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        kv = init_kv_cache(cfg, batch, max_len, device=self.device)
        cross = init_kv_cache(cfg, batch, cfg.n_frames, device=self.device)
        return {"pos": torch.zeros((), dtype=torch.int32, device=self.device),
                "k": kv["k"], "v": kv["v"], "ck": cross["k"],
                "cv": cross["v"]}

    def cache_logical_axes(self, cache) -> dict:
        kv = ("layers", "batch", "kv_seq", None, "head_dim")
        ckv = ("layers", "batch", "frames", None, "head_dim")
        return {"pos": (), "k": kv, "v": kv, "ck": ckv, "cv": ckv}

    def warm_cross_cache(self, cache, frame_embeds) -> dict:
        """Precompute cross-attention K/V from the encoder memory: a new
        cache with ``ck``/``cv`` filled, the rest ``cache``'s."""
        cfg = self.cfg
        params = self._cast()
        memory = self._encode(params, frame_embeds)
        ck = torch.empty_like(cache["ck"])
        cv = torch.empty_like(cache["cv"])
        shape = (*memory.shape[:-1], cfg.n_kv_heads, cfg.head_dim)
        for i, lp in enumerate(params["dec_layers"]):
            ck[i] = (memory @ lp["cross"]["wk"]).reshape(shape).to(cfg.adtype)
            cv[i] = (memory @ lp["cross"]["wv"]).reshape(shape).to(cfg.adtype)
        return dict(cache, ck=ck, cv=cv)

    def decode_step(self, cache, tokens):
        """tokens (B,1) -> (logits (B,V), new cache).  One step; the
        cross memories are read, never written."""
        cfg = self.cfg
        params = self._cast()
        pos = cache["pos"]
        tokens = self._tokens(tokens)
        B = tokens.shape[0]
        x = params["embed"][tokens].to(cfg.adtype)
        posb = pos.expand(B)
        T = cache["ck"].shape[2]
        ready = torch.ones((B, T), dtype=torch.bool, device=x.device)
        at_end = torch.full((B,), T - 1, dtype=torch.int32, device=x.device)
        in_place = cfg.cache_update == "dus"
        new_k = cache["k"] if in_place else torch.empty_like(cache["k"])
        new_v = cache["v"] if in_place else torch.empty_like(cache["v"])
        for i, lp in enumerate(params["dec_layers"]):
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            a, k, v = attn_decode(lp["attn"], h, cache["k"][i],
                                  cache["v"][i], posb, cfg, is_local=False)
            if not in_place:
                new_k[i] = k
                new_v[i] = v
            x = x + a
            h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            # cross-attn against the precomputed (static) memory cache
            c, _, _ = attn_decode(lp["cross"], h2, cache["ck"][i],
                                  cache["cv"][i], at_end, cfg,
                                  is_local=False, kv_ready=ready,
                                  write=False)
            x = x + c
            x = x + glu_mlp(lp["mlp"], rmsnorm(x, lp["norm3"], cfg.norm_eps),
                            cfg.act)
        logits = self._head(params, x)[:, 0]
        new: dict[str, Any] = dict(cache, k=new_k, v=new_v, pos=pos + 1)
        return logits, new
