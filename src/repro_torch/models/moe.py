"""Top-k MoE block (grouped GShard one-hot baseline + sort-free scatter
path) with the optional parallel dense-residual branch (Arctic).

Port of ``repro/models/moe.py``.  Tokens are dispatched in groups of
``cfg.moe_group_size``; each group routes on its own with capacity
``C_g`` (``_group``, copied as written), and both dispatches drop the
tokens over capacity in arrival order within the group.  ``moe_impl``
picks ``"onehot"`` (the GShard dispatch einsum) or ``"scatter"``
(positions by a grouped cumsum, then a gather and a combine).

Where torch and jnp differ, the port keeps the reference's numbers:

* the router runs in float32 on float32 operands (jnp promotes the
  float32 activations times the cast router; torch would refuse the
  mixed product), so ``p["router"]`` is upcast explicitly;
* ``lax.top_k`` takes the lower index among ties; ``torch.topk``
  promises no order, so the top k come from a stable descending sort;
* the scatter's combine, ``.at[gidx, tok].add(vals)``, is a float
  scatter-add.  Every token owns exactly k consecutive slots of
  ``vals``, so it is summed here as k dense adds in slot order, from
  zero: no atomics, the same bits every call (and the order XLA's
  serial scatter on the CPU adds them in);
* the backwards of the scatter dispatch's two gathers add nothing in an
  order-dependent way (autograd's would scatter-add, with atomics on a
  CUDA tensor): :class:`_RepeatTokens` sums each token's k slot
  gradients in slot order, as the combine does, and
  :class:`_GatherSlots` writes each gathered gradient to its unique
  ``(expert, slot)`` pair.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ACTS, Leaf, glu_mlp, glu_spec, materialize

__all__ = ["init_moe", "moe_spec", "moe_forward"]


def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype
    p = {"router": Leaf((d, e), torch.float32, 0),
         "w_gate": Leaf((e, d, f), pd, 1),
         "w_up": Leaf((e, d, f), pd, 1),
         "w_down": Leaf((e, f, d), pd, 1)}
    if cfg.dense_residual_ff:
        p["dense"] = glu_spec(d, cfg.dense_residual_ff, pd)
    return p


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    return materialize(moe_spec(cfg), generator)


def _group(cfg: ModelConfig, T: int) -> tuple[int, int, int]:
    """(n_groups, group_size, capacity_per_group)."""
    tg = min(cfg.moe_group_size, T)
    while T % tg:            # shapes here are powers of two in practice
        tg -= 1
    g = T // tg
    c = int(cfg.capacity_factor * cfg.top_k * tg / cfg.n_experts) + 1
    c = min(tg, max(4, -(-c // 4) * 4))
    return g, tg, c


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among ties (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, xf, cfg):
    """Router in f32: top-k expert ids + renormalized gates + aux loss."""
    logits = xf.float() @ p["router"].float()            # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, cfg.top_k)                 # (G, Tg, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(idx[..., 0], cfg.n_experts).float(),
                    dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * ce)
    return gates, idx, aux


def _expert_glu(p, h, cfg):
    """h (G, E, C, D) -> (G, E, C, D), batched over groups × experts
    (every expert's capacity buffer, empty ones included, as the
    reference): one batched product per weight, experts as the batch."""
    act = ACTS[cfg.act]
    G, E, C, D = h.shape
    wg = p["w_gate"].to(h.dtype)
    wu = p["w_up"].to(h.dtype)
    wd = p["w_down"].to(h.dtype)
    hb = h.transpose(0, 1).reshape(E, G * C, D)
    y = act(torch.bmm(hb, wg)) * torch.bmm(hb, wu)         # (E, G·C, F)
    return torch.bmm(y, wd).reshape(E, G, C, D).transpose(0, 1)


def _dispatch_onehot(p, x, gates, idx, cfg, C):
    """x (G,Tg,D); the GShard dispatch-einsum baseline."""
    G, Tg, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    oh = F.one_hot(idx, E)                                   # (G,Tg,k,E)
    flat = oh.reshape(G, Tg * k, E)
    pos = torch.cumsum(flat, dim=1) * flat                   # 1-based
    pos = pos.reshape(G, Tg, k, E)
    keep = (pos > 0) & (pos <= C)                            # (G,Tg,k,E)
    slot = torch.clamp(pos - 1, 0, C - 1)
    slot_oh = F.one_hot(slot, C).to(x.dtype)                 # (G,Tg,k,E,C)
    disp = (slot_oh * keep[..., None].to(x.dtype)).sum(2)    # (G,Tg,E,C)
    h = torch.einsum("gtec,gtd->gecd", disp, x)
    y = _expert_glu(p, h, cfg)
    weight = keep.to(x.dtype) * gates[..., None].to(x.dtype)
    gate_e = (slot_oh * weight[..., None]).sum(2)            # (G,Tg,E,C)
    return torch.einsum("gtec,gecd->gtd", gate_e, y)


class _RepeatTokens(torch.autograd.Function):
    """x (G, Tg, D) -> x[:, tok] (G, Tg·k, D), ``tok = repeat(arange(Tg),
    k)``: each token's row k times.  The backward adds each token's k
    slot gradients in slot order from zero (a reshape and k adds)."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        G, Tg, D = x.shape
        return x[:, :, None].expand(G, Tg, k, D).reshape(G, Tg * k, D)

    @staticmethod
    def backward(ctx, g):
        k = ctx.k
        G, N, D = g.shape
        g = g.reshape(G, N // k, k, D)
        out = torch.zeros((G, N // k, D), dtype=g.dtype, device=g.device)
        for j in range(k):
            out = out + g[:, :, j]
        return out, None


class _GatherSlots(torch.autograd.Function):
    """y (G, E, C, D) -> ypad[gidx, e, slot] (G, N, D), ``ypad`` y with a
    zero overflow slot C.  The backward writes each row's gradient to its
    ``(expert, slot)`` (a plain write: a kept pair is unique within its
    group, and the overflow rows all land in slot C, which is cut off)."""

    @staticmethod
    def forward(ctx, y, gidx, e_flat, slot):
        G, E, C, D = y.shape
        ypad = torch.cat([y, torch.zeros((G, E, 1, D), dtype=y.dtype,
                                         device=y.device)], dim=2)
        ctx.save_for_backward(gidx, e_flat, slot)
        ctx.shape = y.shape
        return ypad[gidx, e_flat, slot]

    @staticmethod
    def backward(ctx, g):
        gidx, e_flat, slot = ctx.saved_tensors
        G, E, C, D = ctx.shape
        gy = torch.zeros((G, E, C + 1, D), dtype=g.dtype, device=g.device)
        gy[gidx, e_flat, slot] = g
        return gy[:, :, :C], None, None, None


def _dispatch_scatter(p, x, gates, idx, cfg, C):
    """x (G,Tg,D); grouped sort-free scatter dispatch."""
    G, Tg, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = Tg * k
    e_flat = idx.reshape(G, N)
    g_flat = gates.reshape(G, N).to(x.dtype)
    oh = F.one_hot(e_flat, E)                                # (G,N,E)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1         # (G,N)
    keep = pos < C
    slot = torch.where(keep, pos, C)                         # C = overflow
    gidx = torch.arange(G, device=x.device)[:, None].expand(G, N)
    buf = torch.zeros((G, E, C + 1, D), dtype=x.dtype, device=x.device)
    # a plain (non-accumulating) write: a kept (expert, slot) pair is
    # unique within its group by the cumsum, and the writes that collide
    # all land in the overflow slot C, which is cut off below
    buf[gidx, e_flat, slot] = _RepeatTokens.apply(x, k)
    y = _expert_glu(p, buf[:, :, :C], cfg)                   # (G,E,C,D)
    vals = _GatherSlots.apply(y, gidx, e_flat, slot) * (
        g_flat * keep.to(x.dtype))[..., None]
    # the scatter-add over tok = repeat(arange(Tg), k): token t's k slots
    # are vals[:, t*k : t*k + k], added in slot order from zero
    vals = vals.reshape(G, Tg, k, D)
    out = torch.zeros((G, Tg, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + vals[:, :, j]
    return out


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> ((B, S, D), aux_loss)."""
    B, S, D = x.shape
    T = B * S
    G, Tg, C = _group(cfg, T)
    xg = x.reshape(G, Tg, D)
    gates, idx, aux = _router(p, xg, cfg)
    if cfg.moe_impl == "scatter":
        y = _dispatch_scatter(p, xg, gates, idx, cfg, C)
    else:
        y = _dispatch_onehot(p, xg, gates, idx, cfg, C)
    y = y.reshape(B, S, D)
    if "dense" in p:  # arctic: parallel dense residual branch
        y = y + glu_mlp(p["dense"], x, cfg.act)
    return y, aux
