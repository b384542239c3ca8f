"""Step factories shared by the serve driver and tests.

Port of ``repro/launch/steps.py``'s serving half: the steps take what the
reference's take minus ``params``, which the model holds.  The training
step and state wait for the training slice."""

from __future__ import annotations

from typing import Callable

__all__ = ["make_prefill_step", "make_decode_step"]


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
