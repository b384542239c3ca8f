"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``.  The params, gradients and moments are
ordered dicts of tensors keyed by parameter name (``model.
named_parameters()``'s names, e.g. ``layers.0.attn.wq``), not a
``torch.optim`` optimizer.  Each leaf is updated in float32 in the
reference's order of operations and cast back to its dtype:

1. the clip scale ``min(1, clip / (gnorm + 1e-9))``;
2. the bias corrections ``1 - b ** step`` in float32;
3. ``mu_hat / (sqrt(nu_hat) + eps) + wd * p``;
4. ``p - lr * delta``.

:func:`adamw_update` writes the params and the moments in place (under
``torch.no_grad()``), the counterpart of the reference's donated
buffers.  :func:`global_norm` sums the leaves' float32 sums of squares
in the reference's leaf order: jax flattens the param tree by sorted
keys with each layer param stacked over the layers, so the port groups
``layers.<i>.<path>`` by ``<path>``, sums each group over its layers in
layer order, and adds the groups in sorted path order.  It is
deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "reference_order"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def _reference_key(name: str) -> tuple[tuple[str, ...], int]:
    """``layers.3.attn.wq`` -> (("layers", "attn", "wq"), 3): the leaf's
    path in the reference's stacked tree and its layer (-1 for a param
    outside the layer stacks)."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return tuple(parts[:i] + parts[i + 1:]), int(p)
    return tuple(parts), -1


def reference_order(names) -> list[list[str]]:
    """The names grouped by reference leaf, in jax's flatten order (sorted
    key paths), each group in layer order."""
    groups: dict[tuple[str, ...], list[tuple[int, str]]] = {}
    for name in names:
        path, layer = _reference_key(name)
        groups.setdefault(path, []).append((layer, name))
    return [[n for _, n in sorted(groups[path])] for path in sorted(groups)]


def _sum_sq(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32)
    return torch.sum(t * t)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares, in the
    reference's leaf order."""
    return torch.sqrt(sum(sum(_sum_sq(tree[name]) for name in group)
                          for group in reference_order(tree)))


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device if params else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in params.items()},
    }


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step: ``params`` and ``state``'s moments updated in place.
    Returns ``(params, new_state, metrics)`` with ``metrics`` the raw
    gradient norm and the step's learning rate (float32 0-d tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    c1 = 1 - torch.pow(b1, sf)
    c2 = 1 - torch.pow(b2, sf)
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].to(torch.float32) * scale
        m = b1 * mu + (1 - b1) * g
        v = b2 * nu + (1 - b2) * g * g
        mu_hat = m / c1
        nu_hat = v / c2
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
        pf = p.to(torch.float32)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
        mu.copy_(m)
        nu.copy_(v)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}, \
        metrics
