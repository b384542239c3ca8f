"""End-to-end training driver (CPU-runnable at smoke scale).

Port of ``repro/launch/train.py``: data pipeline → train step →
checkpoint/restart → watchdog + straggler detection → elastic mesh
choice, with the reference's flags and output lines, plus ``--device``
(default ``cuda``; ``RuntimeError`` without a card) and ``--layers`` (the
config's first N layers at full width, as the serve driver's).

The port has no sharded tensor type yet, so every param lives on
``--device`` and the printed mesh is the one-device grid that trains
(``--max-model-axis`` is accepted for the reference's command lines).  The checkpoint is the reference's tree, ``{"params":
<layer params stacked (L, ...)>, "opt": {"step", "mu", "nu"}}`` under the
reference's leaf names, so either package resumes the other's run.
Weights are drawn by the reference's initializers from a torch
generator seeded 0 (not jax's bits).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --device cpu --steps 200 --ckpt /tmp/ckpt
  # kill it mid-run, re-run the same command: resumes from the last step.
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --layers 2 --batch 2 --seq 2048 --steps 12 --lr 1e-3
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.core.radic import resolve_device
from repro_torch.data import DataConfig, Prefetcher, SyntheticLMData
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.convert import (load_reference,
                                        opt_state_from_reference,
                                        reference_tree)
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.runtime import StepTimer, Watchdog, choose_mesh

__all__ = ["main", "checkpoint_tree", "load_checkpoint_tree"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-model-axis", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cuda, cuda:N or cpu)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers at full width")
    return ap


def checkpoint_tree(model, opt_state, *, meta: bool = False) -> dict:
    """The train state in the reference's checkpoint layout, torch leaves
    (``meta``: shapes and dtypes only, a restore's ``like``)."""
    def leaves(named):
        return {k: v.to("meta") if meta else v for k, v in named.items()}

    step = opt_state["step"]
    return {"params": reference_tree(model,
                                     leaves(dict(model.named_parameters()))),
            "opt": {"step": step.to("meta") if meta else step,
                    "mu": reference_tree(model, leaves(opt_state["mu"])),
                    "nu": reference_tree(model, leaves(opt_state["nu"]))}}


def load_checkpoint_tree(model, tree) -> dict:
    """Copy a restored checkpoint tree's params into ``model``; return its
    AdamW state on the model's device."""
    load_reference(model, tree["params"])
    return opt_state_from_reference(model, tree["opt"])


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    opt_cfg = AdamWConfig(lr=warmup_cosine(args.lr, 20, args.steps),
                          weight_decay=0.01)

    plan = choose_mesh(1, max_model=args.max_model_axis)
    print(f"mesh: {plan.shape} {plan.axis_names} "
          f"({plan.n_devices} devices)")

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    model, opt_state = init_train_state(
        cfg, opt_cfg, torch.Generator(device).manual_seed(0), device=device)
    step_fn = make_train_step(model, opt_cfg)

    start = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt)
        restored = mgr.restore(checkpoint_tree(model, opt_state, meta=True),
                               device=model.device)
        if restored is not None:
            start, tree = restored
            opt_state = load_checkpoint_tree(model, tree)
            print(f"resumed from step {start}")

    wd = Watchdog(timeout_s=300.0,
                  on_stall=lambda: print("WATCHDOG: step stalled"))
    wd.start()
    timer = StepTimer()
    fetch = Prefetcher(data, start_step=start)
    losses = []
    try:
        for _ in range(start, args.steps):
            step_i, batch = fetch.next()
            batch = {k: torch.as_tensor(v, device=model.device)
                     for k, v in batch.items()}
            t0 = time.time()
            opt_state, metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            wd.beat()
            if timer.record(step_i, dt):
                print(f"  straggler step {step_i}: {dt:.2f}s "
                      f"(ema {timer.ema:.2f}s)")
            losses.append(loss)
            if step_i % args.log_every == 0:
                print(f"step {step_i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt:.2f}s")
            if mgr and (step_i + 1) % args.ckpt_every == 0:
                mgr.save_async(step_i + 1, checkpoint_tree(model, opt_state))
        if mgr:
            mgr.save(args.steps, checkpoint_tree(model, opt_state))
    finally:
        fetch.close()
        wd.stop()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"stragglers={timer.stragglers}")
    return losses


if __name__ == "__main__":
    main()
