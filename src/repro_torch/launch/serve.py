"""Batched serving driver: prefill a request batch, decode greedily with
the KV/SSM cache, slot-recycling continuous batching when requests
finish early (EOS).

Port of ``repro/launch/serve.py`` for every family of the zoo: the
reference's flags and output lines, plus ``--device`` (default ``cuda``;
``RuntimeError`` without a card), ``--layers`` (a depth cut at full
width) and one line of prefill and decode times.  Weights are random,
drawn by the reference's initializers from a torch generator seeded 0.
Runs under ``torch.inference_mode()``; greedy ``argmax`` takes the first
maximum, as ``jnp.argmax`` does.

The audio family (the encoder–decoder) has no prefill: as in the
reference, stand-in frames (a generator seeded 1) warm the cross cache
and the prompt is forced through ``decode_step`` a token at a time, and
its ``prefill_ms`` times both.  The ssm and hybrid caches (conv tail,
state) go through the same greedy and EOS loop as the KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --batch 4 --prompt-len 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --smoke --device cpu --batch 2 --prompt-len 8 --gen 6 [--eos ID]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \\
      --layers 2 --batch 4 --prompt-len 16 --gen 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.radic import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.frontends import (synthetic_frame_embeds,
                                          synthetic_patch_embeds)

__all__ = ["main", "run"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--eos", type=int, default=-1,
                    help="token id treated as EOS (slot recycled)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda, cuda:N or cpu)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N (decoder) layers at "
                         "full width: a depth cut for a model larger "
                         "than the card")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> dict:
    """Serve one batch as :func:`main` does and return what it measured:
    ``tokens`` (B, gen), ``logits`` (the prefill's and each decode step's
    (B, V) float32 logits, on the device), ``prompts``, ``prefix_embeds``,
    ``frame_embeds`` (audio), ``prefill_ms`` (audio: the warm cross cache
    and the forced prompt), ``decode_ms`` (per step), ``tok_s``,
    ``live``, ``n_live_tokens`` and the ``model``."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    model = build_model(cfg, device=device)
    max_len = args.prompt_len + args.gen + \
        (cfg.n_patches if cfg.prefix_embeds else 0)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len))
    with torch.inference_mode():
        model.init(torch.Generator(device).manual_seed(0))
        batch = {"tokens": torch.as_tensor(prompts, device=device)}
        if cfg.prefix_embeds:
            batch["prefix_embeds"] = synthetic_patch_embeds(
                torch.Generator(device).manual_seed(1), args.batch,
                cfg.n_patches, cfg.d_model)
        frames = None
        if cfg.family == "audio":
            frames = synthetic_frame_embeds(
                torch.Generator(device).manual_seed(1), args.batch,
                cfg.n_frames, cfg.d_model)
        decode = make_decode_step(model)
        _sync(device)
        t_pre = time.perf_counter()
        if frames is not None:
            cache = model.warm_cross_cache(
                model.init_cache(args.batch, max_len), frames)
            # feed the prompt through decode (whisper-style forced prefix)
            for t in range(args.prompt_len):
                logits, cache = decode(cache, {"tokens": batch["tokens"][
                    :, t:t + 1]})
        else:
            logits, cache = make_prefill_step(model, max_len)(batch)
        _sync(device)
        prefill_s = time.perf_counter() - t_pre
        kept = [logits]
        out_tokens = []
        live = np.ones(args.batch, bool)
        n_live_tokens = 0  # only live slots count toward throughput
        t0 = time.perf_counter()
        tok = torch.argmax(logits, dim=-1)[:, None].int()
        for _ in range(args.gen):
            cur = tok[:, 0].cpu().numpy()
            if args.eos >= 0:
                # dead slots emit EOS padding, not stale argmax output
                cur = np.where(live, cur, args.eos)
            out_tokens.append(cur)
            n_live_tokens += int(live.sum())
            logits, cache = decode(cache, {"tokens": tok})
            kept.append(logits)
            tok = torch.argmax(logits, dim=-1)[:, None].int()
            if args.eos >= 0:
                done = tok[:, 0].cpu().numpy() == args.eos
                live &= ~done  # freed slots would admit queued requests
        _sync(device)
        dt = time.perf_counter() - t0
    gen = np.stack(out_tokens, axis=1)
    tps = n_live_tokens / dt
    print(f"prefill {prefill_s * 1e3:.3f} ms; decode "
          f"{dt * 1e3 / max(args.gen, 1):.3f} ms/step on {device}")
    print(f"generated {gen.shape} tokens in {dt:.2f}s "
          f"({tps:.1f} tok/s over {n_live_tokens} live tokens); "
          f"live={int(live.sum())}/{args.batch}")
    print("sample:", gen[0, :16])
    return {"tokens": gen, "logits": kept, "prompts": prompts,
            "prefix_embeds": batch.get("prefix_embeds"),
            "frame_embeds": frames,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms": dt * 1e3 / max(args.gen, 1), "tok_s": tps,
            "live": int(live.sum()), "n_live_tokens": n_live_tokens,
            "model": model}


def main(argv=None):
    """The serve CLI: returns the ``(B, gen)`` generated tokens."""
    return run(argv)["tokens"]


if __name__ == "__main__":
    main()
