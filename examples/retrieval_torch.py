"""Video retrieval with non-square determinant signatures, on the
PyTorch/CUDA port: ``examples/retrieval.py`` through ``repro_torch``.

Each "video" is an m×n_i feature matrix (m pooled channels, n_i frames —
n_i varies per video).  Signature: Radic determinants of sliding (m × w)
windows, a size-invariant descriptor.  A query is a noisy clip of one
video; nearest-signature retrieval must find its source.

* The window determinants are evaluated in **one batched dispatch**
  (:func:`repro_torch.core.radic_det_batched` over the (K, m, w) window
  stack: the batched forward kernel on the card) instead of a Python
  loop of scalar calls — same numbers (the loop is kept below only as a
  parity check);
* retrieval is sharpened by **gradient-based query refinement**: the
  query signature is differentiable in the query features (its backward
  is the cofactor-form backward kernel on the card), so for each
  shortlisted candidate we descend a few steps on the query perturbation
  that aligns the signatures, and re-rank by the aligned distance.

  PYTHONPATH=src python examples/retrieval_torch.py              # the card
  PYTHONPATH=src python examples/retrieval_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import radic_det, radic_det_batched
from repro_torch.core.radic import resolve_device

M, W, STRIDE = 4, 6, 2     # pooled channels, window frames, window stride
REFINE_TOPK = 3            # candidates taken into the refinement round
REFINE_STEPS = 25
REFINE_LR = 0.1
RIDGE = 0.05               # perturbation penalty: impostors must pay for it


def window_stack(feats: torch.Tensor) -> torch.Tensor:
    """Sliding (M, W) windows of an (M, n) feature matrix -> (K, M, W)."""
    n = feats.shape[1]
    return torch.stack([feats[:, s:s + W]
                        for s in range(0, n - W + 1, STRIDE)])


def signature(feats: torch.Tensor) -> torch.Tensor:
    """L2-normalized vector of windowed Radic determinants — one batched
    dispatch over the window stack."""
    dets = radic_det_batched(window_stack(feats))
    return dets / (torch.linalg.norm(dets) + 1e-8)


def signature_loop(feats: torch.Tensor) -> np.ndarray:
    """The naive scalar-loop signature (one radic_det call per window),
    kept as the parity reference for the batched path."""
    sig = [float(radic_det(feats[:, s:s + W]))
           for s in range(0, feats.shape[1] - W + 1, STRIDE)]
    sig = np.array(sig, np.float32)
    return sig / (np.linalg.norm(sig) + 1e-8)


def sim(a: np.ndarray, b: np.ndarray) -> float:
    L = min(len(a), len(b))
    return float(a[:L] @ b[:L])


def _refine_step(delta, Q, target, L):
    """One descent step on the query perturbation: pull the (truncated)
    query signature toward the candidate's, ridge-penalizing the
    perturbation.  Differentiates through radic_det_batched."""
    d = delta.detach().requires_grad_(True)
    s = signature(Q + d)
    loss = torch.sum((s[:L] - target[:L]) ** 2) + RIDGE * torch.sum(d * d)
    g, = torch.autograd.grad(loss, d)
    return (delta - REFINE_LR * g).detach(), loss.detach()


def refined_distance(Q: torch.Tensor, target_sig: torch.Tensor) -> float:
    """How cheaply a small query perturbation aligns the signatures —
    the re-ranking score (lower = better match)."""
    with torch.no_grad():
        L = min(int(signature(Q).shape[0]), int(target_sig.shape[0]))
    delta = torch.zeros_like(Q)
    val = torch.tensor(float("inf"))
    for _ in range(REFINE_STEPS):
        delta, val = _refine_step(delta, Q, target_sig, L)
    return float(val)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to compute on (cuda, cuda:N or cpu)")
    device = resolve_device(ap.parse_args(argv).device)

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    rng = np.random.default_rng(0)
    library = [rng.normal(size=(M, rng.integers(18, 40))).astype(np.float32)
               for _ in range(12)]             # different n_i per video!
    with torch.no_grad():
        sigs = [signature(on(v)).cpu().numpy() for v in library]

        # batched-vs-loop parity: the one-dispatch signature must
        # reproduce the scalar-loop signature
        worst = max(float(np.max(np.abs(s - signature_loop(on(v)))))
                    for v, s in zip(library, sigs))
    print(f"batched-vs-loop signature parity: worst |diff| = {worst:.2e}")
    assert worst <= 1e-5, worst

    hits = refined_hits = 0
    for target in range(len(library)):
        clip = library[target] + 0.35 * rng.normal(
            size=library[target].shape).astype(np.float32)
        Q = on(clip)
        with torch.no_grad():
            q = signature(Q).cpu().numpy()
        ranked = sorted(range(len(library)), key=lambda i: -sim(q, sigs[i]))
        hit = ranked[0] == target
        hits += hit

        # gradient round: re-rank the shortlist by aligned distance
        short = ranked[:REFINE_TOPK]
        dists = {i: refined_distance(Q, on(sigs[i])) for i in short}
        best = min(short, key=dists.get)
        rhit = best == target
        refined_hits += rhit
        print(f"query from video {target:2d} (n={library[target].shape[1]}) "
              f"-> sim {ranked[0]:2d} {'OK  ' if hit else 'MISS'} "
              f"| refined {best:2d} {'OK' if rhit else 'MISS'}")

    print(f"\ntop-1 accuracy: similarity {hits}/{len(library)}, "
          f"gradient-refined {refined_hits}/{len(library)}")
    assert refined_hits >= hits, "refinement must not lose matches"
    assert refined_hits >= 10, "retrieval degraded"
    return hits, refined_hits


if __name__ == "__main__":
    main()
