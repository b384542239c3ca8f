#!/usr/bin/env python3
"""Where the bf16 serving path of the ssm and hybrid archs departs from
float32, on one CUDA card (the numbers behind PERF.md's bf16 finding).

    python3 lm_precision.py

For mamba2-1.3b (a 300-token prompt) and hymba-1.5b (1,100 tokens) at
full width in bf16 (random weights from ``torch.Generator`` seed 0, 4
prompts from numpy seed 0, 32 greedy tokens, as ``chip_smoke.py``'s
phase 17 serves them), it prints the relative Frobenius error of the
teacher-forced bf16 logits against the model's own float32 copy:

* as the port computes (the SSM's elementwise chains in float32),
  overall, on the prefill's row and on the decode rows, and with
  cuBLAS's reduced-precision bf16 reductions off;
* with the SSM rounding every elementwise op to bf16, as eager jnp does
  (the reference's op-by-op semantics), and with the whole SSM mixer in
  float32;

and, for each of the three, the residual stream's error after each
layer of the prefill.  It imports ``chip_smoke.py``'s helpers and
nothing of jax.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
ARCHS = (("mamba2-1.3b", 300), ("hymba-1.5b", 1100))
GEN = 32


def op_by_op(ssm):
    """The SSM's ``ssm_forward`` and ``ssm_decode`` with every
    elementwise op rounded to the activations' dtype (eager jnp's
    semantics), from the port's module ``ssm``."""

    def forward(p, x, cfg, return_state=False):
        B, S, _ = x.shape
        ad = x.dtype
        H, P, N, Q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_chunk)
        z, xBC_raw, dt = ssm._split_proj(cfg, x @ p["in_proj"])
        w, b = p["conv_w"].to(ad), p["conv_b"].to(ad)
        K = w.shape[0]
        pad = F.pad(xBC_raw, (0, 0, K - 1, 0))
        xBC = F.silu(sum(pad[:, i:i + S] * w[i] for i in range(K)) + b)
        di = cfg.d_inner
        xs = xBC[..., :di].reshape(B, S, H, P)
        Bm, Cm = xBC[..., di:di + N], xBC[..., di + N:]
        dt = F.softplus(dt.float() + p["dt_bias"])
        dA = dt * -torch.exp(p["A_log"])
        padn = (-S) % Q
        if padn:
            xs, Bm, Cm, dA, dt = (ssm._pad_seq(t, padn)
                                  for t in (xs, Bm, Cm, dA, dt))
        nc = (S + padn) // Q
        xs = xs.reshape(B, nc, Q, H, P)
        Bm, Cm = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
        dA, dt = dA.reshape(B, nc, Q, H), dt.reshape(B, nc, Q, H)
        xdt = xs * dt[..., None].to(ad)
        L = torch.exp(ssm._segsum(torch.movedim(dA, -1, 2)))
        sc = torch.einsum("bcln,bcsn->bcls", Cm, Bm)
        y_diag = torch.einsum("bchls,bcshp->bclhp",
                              (sc[:, :, None] * L).to(ad), xdt)
        cum = torch.cumsum(dA, dim=2)
        tot = cum[:, :, -1:]
        states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bm,
                              torch.exp(tot - cum).to(ad), xdt)
        dec = torch.exp(tot[:, :, 0]).to(ad)
        st, prev = torch.zeros_like(states[:, 0]), []
        for c in range(nc):
            prev.append(st)
            st = st * dec[:, c, :, None, None] + states[:, c]
        y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cm,
                             torch.stack(prev, 1), torch.exp(cum).to(ad))
        y = (y_diag + y_off).reshape(B, -1, H, P)[:, :S]
        y = y + xs.reshape(B, -1, H, P)[:, :S] * p["D"][:, None].to(ad)
        y = gated_norm(y.reshape(B, S, di), z, p["norm_w"], cfg.norm_eps)
        out = y @ p["out_proj"]
        if not return_state:
            return out
        tail = xBC_raw[:, max(0, S - (K - 1)):]
        return out, {"conv": tail.to(ad), "state": st.float()}

    def decode(p, x, conv, state, cfg):
        B, ad = x.shape[0], x.dtype
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        z, xBC, dt = ssm._split_proj(cfg, x[:, 0] @ p["in_proj"])
        window = torch.cat([conv, xBC[:, None, :]], dim=1)
        xBC = F.silu(torch.einsum("bkc,kc->bc", window.float(),
                                  p["conv_w"].float())
                     + p["conv_b"].float()).to(ad)
        di = cfg.d_inner
        xs = xBC[:, :di].reshape(B, H, P)
        Bm, Cm = xBC[:, di:di + N].float(), xBC[:, di + N:].float()
        dt = F.softplus(dt.float() + p["dt_bias"])
        dA = torch.exp(dt * -torch.exp(p["A_log"]))
        upd = torch.einsum("bhp,bn->bhpn", xs.float() * dt[..., None], Bm)
        new = (state.float() * dA[:, :, None, None] + upd).to(state.dtype)
        y = torch.einsum("bhpn,bn->bhp", new.float(), Cm) + \
            xs.float() * p["D"][:, None]
        y = gated_norm(y.reshape(B, di).to(ad), z, p["norm_w"],
                       cfg.norm_eps)
        return (y @ p["out_proj"])[:, None, :], window[:, 1:], new

    return forward, decode


def gated_norm(y, z, w, eps):
    """mamba2's gated norm with ``y * silu(z)`` rounded to ``y``'s dtype
    before the float32 norm (eager jnp's semantics)."""
    yf = (y * F.silu(z)).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1 + w.float())).to(y.dtype)


def in_float32(ssm):
    """The whole SSM mixer in float32 (its weights upcast), rounded to
    the activations' dtype at its output."""
    fwd, dec = ssm.ssm_forward, ssm.ssm_decode

    def forward(p, x, cfg, return_state=False):
        p32 = {k: v.float() for k, v in p.items()}
        out = fwd(p32, x.float(), cfg.replace(dtype="float32"),
                  return_state)
        if not return_state:
            return out.to(x.dtype)
        y, st = out
        return y.to(x.dtype), {"conv": st["conv"].to(x.dtype),
                               "state": st["state"]}

    def decode(p, x, conv, state, cfg):
        p32 = {k: v.float() for k, v in p.items()}
        y, c, s = dec(p32, x.float(), conv.float(), state,
                      cfg.replace(dtype="float32"))
        return y.to(x.dtype), c.to(x.dtype), s

    return forward, decode


def residual_errors(cs, mb, m32, prompts) -> list[float]:
    """The prefill's residual stream, bf16 against float32, after each
    layer (relative Frobenius)."""
    errs = []
    with torch.inference_mode():
        pb, p32 = mb._cast(), m32._cast()
        xb, x32 = mb._embed(pb, prompts), m32._embed(p32, prompts)
        pos = mb._positions(xb)
        for lb, l32, fl in zip(pb["layers"], p32["layers"],
                               mb._local_flags()):
            xb, _ = mb._block(lb, xb, pos, bool(fl))
            x32, _ = m32._block(l32, x32, pos, bool(fl))
            errs.append(cs.rel_fro(xb, x32))
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_precision: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, hybrid, lm, ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), f"torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    port = (ssm.ssm_forward, ssm.ssm_decode)

    def use(fns):
        for mod in (lm, hybrid):
            mod.ssm_forward, mod.ssm_decode = fns

    for arch, P in ARCHS:
        cfg = get_config(arch)
        mb = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
        m32 = build_model(cfg.replace(param_dtype="float32",
                                      dtype="float32"))
        with torch.no_grad():
            for a, b in zip(m32.parameters(), mb.parameters()):
                a.copy_(b)
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(4, P)), device="cuda")
        with torch.inference_mode():
            lg, cache = mb.prefill(prompts, P + GEN)
            toks = [lg.argmax(-1)[:, None]]
            for _ in range(GEN - 1):
                lg, cache = mb.decode_step(cache, toks[-1])
                toks.append(lg.argmax(-1)[:, None])
        del cache
        gen = torch.cat(toks, 1)
        want = cs.teacher_forced(m32, prompts, gen, P + GEN)
        for name, fns in (("port", port), ("op by op", op_by_op(ssm)),
                          ("mixer in float32", in_float32(ssm))):
            use(fns)
            got = cs.teacher_forced(mb, prompts, gen, P + GEN)
            line = (f"{arch} {name}: bf16 vs float32 "
                    f"{cs.rel_fro(got, want):.4e} (prefill row "
                    f"{cs.rel_fro(got[:, :1], want[:, :1]):.4e}, decode "
                    f"rows {cs.rel_fro(got[:, 1:], want[:, 1:]):.4e})")
            if name == "port":
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = False
                off = cs.teacher_forced(mb, prompts, gen, P + GEN)
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = True
                line += (f"; reduced-precision reductions off "
                         f"{cs.rel_fro(off, want):.4e}")
            errs = residual_errors(cs, mb, m32, prompts)
            print(line + "; residual stream after each layer: "
                  + " ".join(f"{e:.2e}" for e in errs), flush=True)
            use(port)
        del mb, m32, want
        cs.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
