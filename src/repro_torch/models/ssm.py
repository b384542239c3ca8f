"""Mamba-2 SSD (state-space duality) mixer: the chunked scan for prefill
(O(S·chunk) per head) and the O(1)-state single-token decode.

Port of ``repro/models/ssm.py`` (the minimal SSD of arXiv:2405.21060 §6,
n_groups = 1): in_proj -> [z | x | B | C | dt]; causal conv over
[x | B | C]; SSD; gated RMSNorm; out_proj.  The same math in eager torch,
with each of the reference's casts: the intra-chunk weights ``sc * L``
are float32 and are cast to the activations' dtype before their
product; every product takes operands in the activations' dtype and
gives its result in it; the chunk states and the scan over chunks
(``lax.scan`` there, a Python loop here) carry the activations' dtype;
the decode state is ``cfg.ssm_state_dtype``.  ``_segsum`` is the
reference's (a cumsum difference, ``-inf`` above the diagonal), not the
"stable" segment sum, which rounds differently.

One deliberate difference: the elementwise chains between those
products and casts (the causal conv, the dt scaling, the skip term, the
gated norm, the scan's multiply-add) compute in float32 and round once,
where eager jnp rounds every op to bf16, as a fused SSD kernel does.  In
float32 the two are the same computation; in bf16 the port's mixer
stays closer to its float32 result than the reference's own bf16 does
(``tests/test_torch_models.py::
test_bf16_ssm_is_no_further_from_float32_than_the_reference``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, torch_dtype
from .layers import Leaf, materialize

__all__ = ["init_ssm", "ssm_spec", "ssm_forward", "ssm_decode",
           "init_ssm_cache"]


def ssm_spec(cfg: ModelConfig) -> dict:
    d, di, H, pd = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.pdtype
    proj_out = 2 * di + 2 * cfg.ssm_state + H  # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": Leaf((d, proj_out), pd, 0),
        "conv_w": Leaf((cfg.ssm_conv, cfg.conv_dim), pd, 0),
        "conv_b": Leaf((cfg.conv_dim,), pd),
        "A_log": Leaf((H,), f32),               # A = -exp(A_log) = -1
        "D": Leaf((H,), f32, fill=1.0),
        "dt_bias": Leaf((H,), f32, fill=0.5),
        "norm_w": Leaf((di,), pd),
        "out_proj": Leaf((di, d), pd, 0),
    }


def init_ssm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    return materialize(ssm_spec(cfg), generator)


def _split_proj(cfg, proj):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * N]
    dt = proj[..., di + di + 2 * N:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d. xBC (B,S,C), w (K,C); float32 out."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC.float(), (0, 0, K - 1, 0))
    w, b = w.float(), b.float()
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b[None, None, :])


def _gated_norm(y, z, w, eps, dtype):
    """RMSNorm(y * silu(z)) * (1+w) — mamba2's gated output norm, in
    float32, rounded to ``dtype``."""
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1 + w.float())).to(dtype)


def _segsum(a):
    """Causal segment-sum: out[..., l, s] = sum_{s < t <= l} a[..., t].

    a (..., Q); returns (..., Q, Q) with -inf above the diagonal.
    """
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., l, s)
    ar = torch.arange(Q, device=a.device)
    return torch.where(ar[:, None] >= ar[None, :], diff, -torch.inf)


def _pad_seq(t, pad):
    """Zeros after the sequence axis (1) of t."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def ssm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Chunked SSD. x (B, S, D) -> (B, S, D).

    ``return_state=True`` additionally returns the prefill cache
    ``{"conv": (B, K-1, conv_dim), "state": (B, H, P, N)}`` so decode can
    continue from position S.
    """
    B, S, D = x.shape
    ad = x.dtype
    H, P, N, Q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_chunk)
    proj = x @ p["in_proj"]
    z, xBC_raw, dt = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_raw, p["conv_w"].to(ad), p["conv_b"].to(ad))
    xs = xBC[..., :cfg.d_inner].reshape(B, S, H, P)
    Bm = xBC[..., cfg.d_inner:cfg.d_inner + N]          # (B,S,N)
    Cm = xBC[..., cfg.d_inner + N:]                     # (B,S,N)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])  # (B,S,H)
    A = -torch.exp(p["A_log"])                           # (H,)
    dA = dt * A[None, None, :]                           # (B,S,H)

    pad = (-S) % Q
    if pad:
        xs, Bm, Cm, dA, dt = (_pad_seq(t, pad) for t in (xs, Bm, Cm, dA, dt))
    Sp = S + pad
    nc = Sp // Q
    xs = xs.reshape(B, nc, Q, H, P)
    Bm = Bm.reshape(B, nc, Q, N)
    Cm = Cm.reshape(B, nc, Q, N)
    dA = dA.reshape(B, nc, Q, H)
    dtc = dt.reshape(B, nc, Q, H)
    xdt = xs * dtc[..., None].to(ad)                     # dt-scaled input
    # the products' operands, in the activations' dtype
    Bq, Cq, xq = Bm.to(ad), Cm.to(ad), xdt.to(ad)

    # --- intra-chunk (quadratic within Q only) ---
    L = torch.exp(_segsum(torch.movedim(dA, -1, 2)))     # (B,nc,H,Q,Q)
    sc = torch.einsum("bcln,bcsn->bcls", Cq, Bq)         # (B,nc,Q,Q)
    scL = sc[:, :, None] * L                             # (B,nc,H,l,s)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scL.to(ad), xq)

    # --- chunk-final states ---
    cum = torch.cumsum(dA, dim=2)                        # (B,nc,Q,H)
    tot = cum[:, :, -1:, :]                              # (B,nc,1,H)
    decay_out = torch.exp(tot - cum)                     # to chunk end
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bq, decay_out.to(ad),
                          xq)

    # --- inter-chunk recurrence (the reference's scan over chunks) ---
    dec = torch.exp(tot[:, :, 0, :]).to(ad).float()      # (B,nc,H)
    st = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(st)
        st = (st.float() * dec[:, c, :, None, None]
              + states[:, c].float()).to(ad)
    final_state = st
    prev = torch.stack(prev, dim=1)                      # (B,nc,H,P,N)

    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cq, prev,
                         torch.exp(cum).to(ad))
    y = (y_diag.float() + y_off.float()).reshape(B, Sp, H, P)[:, :S]
    y = y + xs.reshape(B, Sp, H, P)[:, :S] * \
        p["D"][None, None, :, None].to(ad)
    y = y.reshape(B, S, cfg.d_inner)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps, ad)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    K = cfg.ssm_conv
    tail = xBC_raw[:, max(0, S - (K - 1)):, :]
    if S < K - 1:
        tail = F.pad(tail, (0, 0, K - 1 - S, 0))
    cache = {"conv": tail.to(cfg.adtype),
             "state": final_state.to(torch_dtype(cfg.ssm_state_dtype))}
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int | None = None,
                   *, device="cuda") -> dict:
    L = n_layers if n_layers is not None else cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.conv_dim),
                            dtype=cfg.adtype, device=device),
        "state": torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state),
                             dtype=torch_dtype(cfg.ssm_state_dtype),
                             device=device),
    }


def ssm_decode(p: dict, x: torch.Tensor, conv_state, ssm_state,
               cfg: ModelConfig):
    """One-token decode. x (B,1,D); conv_state (B,K-1,C); ssm_state
    (B,H,P,N) f32.  Returns (out, new_conv_state, new_ssm_state)."""
    B = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    proj = x[:, 0] @ p["in_proj"]                        # (B, ...)
    z, xBC, dt = _split_proj(cfg, proj)
    window = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float())
    xBC = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)
    xs = xBC[:, :cfg.d_inner].reshape(B, H, P)
    Bm = xBC[:, cfg.d_inner:cfg.d_inner + N]
    Cm = xBC[:, cfg.d_inner + N:]
    dt = F.softplus(dt.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                      # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xs.float() * dt[..., None],
                       Bm.float())
    new_state = (ssm_state.float() * dA[:, :, None, None]
                 + upd).to(ssm_state.dtype)
    y = torch.einsum("bhpn,bn->bhp", new_state.float(), Cm.float())
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(B, cfg.d_inner).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"], cfg.norm_eps, x.dtype)
    out = (y @ p["out_proj"])[:, None, :]
    return out, window[:, 1:], new_state
