"""Step factories shared by the train and serve drivers and tests.

Port of ``repro/launch/steps.py``: the steps take what the reference's
take minus ``params``, which the model holds.  :func:`make_train_step`'s
step returns ``(opt_state, metrics)`` and updates the model's params in
place (the reference's donated buffers); the params record gradients
only inside it, so serving keeps them frozen."""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "init_train_state", "value_and_grad"]


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator, device="cuda"):
    """``(model, opt_state)``: the family's model on ``device`` holding
    params drawn from ``generator``, and AdamW's zero state."""
    model = build_model(cfg, device=device).init(generator)
    return model, adamw_init(dict(model.named_parameters()), opt_cfg)


@contextlib.contextmanager
def _recording(params):
    """The params record gradients inside, and are frozen again after."""
    for p in params:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(False)


def value_and_grad(model, batch) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)``: ``model.loss(batch)`` and its gradient for each
    param, keyed by parameter name (zeros for a param the loss does not
    reach), as ``jax.value_and_grad(model.loss)``."""
    params = dict(model.named_parameters())
    with torch.enable_grad(), _recording(params.values()):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return loss.detach(), {
        name: torch.zeros_like(p) if g is None else g
        for (name, p), g in zip(params.items(), grads)}


def make_train_step(model, opt_cfg: AdamWConfig) -> Callable:
    def train_step(opt_state, batch):
        loss, grads = value_and_grad(model, batch)
        _, opt_state, metrics = adamw_update(
            dict(model.named_parameters()), grads, opt_state, opt_cfg)
        return opt_state, dict(metrics, loss=loss)
    return train_step


def make_prefill_step(model, max_len: int) -> Callable:
    cfg = model.cfg

    def prefill_step(batch):
        if cfg.family == "audio":
            # enc-dec "prefill" = teacher-forced decoder pass over the
            # prompt + encoder memory (cache build happens in decode)
            logits, _ = model.forward(batch["tokens"], batch["frame_embeds"])
            return logits[:, -1]
        return model.prefill(batch["tokens"], max_len=max_len,
                             prefix_embeds=batch.get("prefix_embeds"))
    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(cache, batch):
        return model.decode_step(cache, batch["tokens"])
    return decode_step
