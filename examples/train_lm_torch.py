"""End-to-end training example on the PyTorch/CUDA port, as
``examples/train_lm.py`` runs it on the JAX package: a small LM from the
zoo on the synthetic pipeline, with checkpoint/restart, via the port's
train driver — then a determinant-regularized probe head on top
(DESIGN_GRAD.md), whose ``radic_det`` runs the fused forward kernel and
its cofactor backward on the card.

Defaults are CPU-sized; on real hardware scale with the flags, e.g.
--d-model 768 --layers 12 --vocab 32000 --steps 300 (~100M params).
Without ``--ckpt`` the checkpoints go to a fresh temporary directory.

  PYTHONPATH=src python examples/train_lm_torch.py               # the card
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 40
"""
import argparse
import sys
import tempfile
import types

import numpy as np
import torch

import repro_torch.configs.registry as registry
from repro_torch.core import radic_det
from repro_torch.core.radic import resolve_device
from repro_torch.launch import train as train_driver
from repro_torch.models.config import ModelConfig

ARCH = "example-lm"
K_HEAD, D_HEAD = 3, 8


def example_config(d_model: int, layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense",
        n_layers=layers, d_model=d_model,
        n_heads=d_model // 64, n_kv_heads=max(1, d_model // 128),
        head_dim=64, d_ff=int(2.75 * d_model) // 8 * 8,
        vocab_size=vocab, dtype="float32", param_dtype="float32",
        remat=False)


def register(cfg: ModelConfig) -> None:
    """Register ``cfg`` as ``--arch example-lm`` in the port's registry,
    the way the reference's example registers it in its own."""
    registry.ARCHS[ARCH] = "example_lm_dynamic"
    mod = types.ModuleType("repro_torch.configs.example_lm_dynamic")
    mod.CONFIG = cfg
    mod.smoke = lambda: cfg
    sys.modules["repro_torch.configs.example_lm_dynamic"] = mod


# ---- determinant-regularized probe head --------------------------------
# A non-square (k, d) readout head fit on a *rank-deficient* probe task
# collapses toward low rank — every output reads the same direction.
# Radic's determinant measures exactly that (it is zero iff the head's
# rows are linearly dependent, Definition 3 / Corollary 2), and it is
# differentiable end to end (the engine's cofactor-form backward), so
# `-lam * log |radic_det(H)|` is a drop-in rank regularizer: gradient
# descent trades a sliver of probe loss for a head that keeps its rows
# independent.
def head_data(device) -> tuple[torch.Tensor, ...]:
    """(X, u, v, H0): the probe task's inputs, directions and the head's
    start, drawn from a generator seeded 0."""
    g = torch.Generator(device).manual_seed(0)
    X = torch.randn(256, D_HEAD, generator=g, device=device)
    u = torch.randn(D_HEAD, generator=g, device=device)
    v = torch.randn(K_HEAD, generator=g, device=device)
    H0 = 0.1 * torch.randn(K_HEAD, D_HEAD, generator=g, device=device)
    return X, u, v, H0


def fit_head(lam: float, steps: int, data=None, device="cuda"):
    """Fit H (k, d) to a rank-1 probe task by gradient descent on
    ``mse - lam * log(|radic_det(H)| + 1e-6)``; returns (H, the last
    step's mse, the target variance).  ``data`` is ``(X, u, v, H0)``
    (e.g. the reference's draws), else :func:`head_data`'s."""
    device = resolve_device(device)
    if data is None:
        data = head_data(device)
    X, u, v, H = (a.to(device, torch.float32) if torch.is_tensor(a) else
                  torch.from_numpy(np.array(a, np.float32)).to(device)
                  for a in data)
    Y = (X @ u)[:, None] * v[None, :]        # rank-1 targets
    mse = torch.tensor(float("inf"))
    for _ in range(steps):
        H = H.detach().requires_grad_(True)
        mse = torch.mean((X @ H.T - Y) ** 2)
        reg = -lam * torch.log(torch.abs(radic_det(H)) + 1e-6)
        (g,) = torch.autograd.grad(mse + reg, H)
        H = H.detach() - 0.05 * g
    return H, float(mse.detach()), float(torch.var(Y, correction=0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    ap.add_argument("--head-steps", type=int, default=150,
                    help="probe-head fine-tune steps (det-regularized)")
    ap.add_argument("--device", default="cuda",
                    help="device to compute on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # register so the port's train driver can --arch it
    register(example_config(args.d_model, args.layers, args.vocab))
    with tempfile.TemporaryDirectory() as tmp:
        losses = train_driver.main([
            "--arch", ARCH, "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt", args.ckpt or tmp, "--ckpt-every", "20",
            "--lr", "1e-3", "--device", str(device)])
    assert losses[-1] < losses[0], "loss must decrease"
    print("OK: loss went from %.3f to %.3f" % (losses[0], losses[-1]))

    H_plain, mse_plain, var_y = fit_head(0.0, args.head_steps,
                                         device=device)
    H_reg, mse_reg, _ = fit_head(0.02, args.head_steps, device=device)
    with torch.no_grad():
        det_plain = abs(float(radic_det(H_plain)))
        det_reg = abs(float(radic_det(H_reg)))
    print(f"probe head: mse {mse_plain:.4f} -> {mse_reg:.4f} with det reg "
          f"(target var {var_y:.2f}), |radic_det| {det_plain:.2e} -> "
          f"{det_reg:.2e}")
    assert det_reg > 10 * det_plain, \
        "det regularizer must keep the head full-rank"
    assert mse_reg < 0.05 * var_y, "det reg wrecked the probe fit"
    print("OK: determinant-regularized head stays full-rank")
    return {"losses": losses, "H_plain": H_plain, "H_reg": H_reg}


if __name__ == "__main__":
    main()
