"""Multi-pod dry run: place and run every (architecture × input shape)
cell's step on the production meshes, on the ``meta`` device.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 512 forced host devices and reads XLA's memory and cost
analyses.  The port has no compiler to ask, so it runs the cell's real
step (``make_train_step`` with AdamW, ``make_prefill_step`` or
``make_decode_step``) on ``meta`` tensors, which carry shapes and no
memory, and counts what that run does:

* argument bytes per device, exactly: each argument's shard shape under
  its placement (:func:`~repro_torch.parallel.sharding.
  tree_param_shardings` for params and AdamW's moments, the batch rules
  for inputs, the cache's logical axes for decode) times its itemsize;
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step at
  the per-device batch (the global batch divided by the mesh axes the
  ``"batch"`` rule maps it to), every other dim whole.  It counts
  matmul-class ops only (mm, bmm, addmm, baddbmm, convolution,
  attention kernels); the reference's ``cost_analysis`` counts every op.
  ``flops_per_device`` divides the count by the ``"model"`` axis's size,
  ``flops_global`` multiplies it by the batch split.  Eager counting sees
  every layer, so the reference's extrapolation from two unrolled depths
  (which fixes XLA counting a scan body once) is not carried over;
* temp bytes: the peak of the bytes of live storages the step makes,
  over those alive at its start (:class:`LiveBytes`).  The step runs at
  the per-device batch but with the ``"model"`` axis's splits left out,
  so this is an upper bound per device.

Collectives are absent: the reference parses them from XLA's optimized
HLO, which torch does not produce, and a port step issues none; the
record says so.  ``fits_hbm_80g`` holds argument + temp bytes to one
H100's memory.  Nothing is allocated on any device and nothing touches
CUDA state.  Records go to ``results/dryrun_torch/`` (the reference's to
``results/dryrun/``; a cell already there is read, not rerun).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single   # one cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import (SHAPES, abstract_cache,
                                        abstract_params, applicable,
                                        input_specs, model_flops,
                                        param_count)
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import (Placement, spec_for,
                                           tree_param_shardings)

__all__ = ["lower_cell", "analyze", "run_cell", "main", "LiveBytes",
           "batch_shardings", "HBM_PER_CARD"]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")

# torch.cuda.get_device_properties(0).total_memory of an "NVIDIA H100 80GB
# HBM3" at a 700.00 W power limit, read on the card (chip_smoke.py phase
# 19 prints it beside this constant)
HBM_PER_CARD = 85_017_493_504

COST_METHOD = "counted-eager (meta)"
TEMP_METHOD = ("peak of live bytes the step makes on meta at the "
               "per-device batch, over those alive at its start; the "
               "'model' axis's splits left out: an upper bound per device")
NO_COLLECTIVES = ("absent: the reference parses XLA's optimized HLO, which "
                  "torch does not produce, and a port step issues no "
                  "collectives")
NO_BYTES = "absent: FlopCounterMode counts no bytes"


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of live ``meta`` storages the ops under it make:
    each new output storage adds its ``nbytes()``, and its release (a
    ``weakref.finalize`` on the storage) takes them back off.  Storages
    of ``existing`` tensors (the step's arguments) are not counted, nor
    are views or in-place results of them."""

    def __init__(self, existing=()):
        super().__init__()
        self._old = [t.untyped_storage() for t in existing]
        self._ids = {id(s) for s in self._old}
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                st = t.untyped_storage()
                if id(st) in self._ids:
                    continue
                n = st.nbytes()
                self._ids.add(id(st))
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, id(st), n)
        return out

    def _free(self, key: int, n: int) -> None:
        self._ids.discard(key)
        self.live -= n


def batch_shardings(specs: dict, rules) -> dict:
    """Placements for the data inputs (batch dims over pod+data)."""
    mesh = rules.mesh
    return {k: Placement(mesh, spec_for(
        v.shape, ["batch"] + [None] * (v.ndim - 1), rules.act, mesh))
        for k, v in specs.items()}


def _leaves(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, (torch.Tensor, Placement))]


def _shard_bytes(tensors, placements) -> int:
    return sum(math.prod(p.shard_shape(t.shape)) * t.element_size()
               for t, p in zip(_leaves(tensors), _leaves(placements),
                               strict=True))


@dataclasses.dataclass
class Lowered:
    """A cell's placements: ``args`` maps each argument group (params,
    mu, nu, step, batch, cache) to ``(its meta tree, its placements)``."""
    cfg: object
    shape: object
    mesh: object
    args: dict
    batch_split: int

    def argument_bytes(self) -> int:
        return sum(_shard_bytes(t, p) for t, p in self.args.values())


@dataclasses.dataclass
class Counted:
    """What the step's run on meta counted: matmul-class FLOPs (total and
    by op) and the peak of the bytes it made live."""
    flops: int
    by_op: dict
    temp_bytes: int
    t_run_s: float


def _per_device(specs: dict, rows: int) -> dict:
    return {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype,
                           device="meta") for k, v in specs.items()}


def _run_step(lowered: Lowered) -> Counted:
    """The cell's step on meta at the per-device batch, counted."""
    cfg, sh = lowered.cfg, lowered.shape
    rows = sh.batch // lowered.batch_split
    model = build_model(cfg, device="meta")
    batch = _per_device(input_specs(cfg, sh.name), rows)
    existing = [*model.parameters(), *model.buffers(), *batch.values()]
    if sh.kind == "train":
        opt_cfg = AdamWConfig()
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        existing += _leaves(opt)
        step, args = make_train_step(model, opt_cfg), (opt, batch)
    elif sh.kind == "prefill":
        step, args = make_prefill_step(model, max_len=sh.seq), (batch,)
    else:
        cache = model.init_cache(rows, sh.seq)
        existing += _leaves(cache)
        step, args = make_decode_step(model), (cache, batch)
    t0 = time.time()
    with FlopCounterMode(display=False) as fc, LiveBytes(existing) as lb:
        out = step(*args)
        del out
    by_op = {str(k): int(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return Counted(int(fc.get_total_flops()), by_op, lb.peak,
                   time.time() - t0)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None):
    """Place + run one (arch × shape × mesh) cell on meta.  Returns
    (lowered, counted, meta); ``(None, None, {"skipped": reason})`` for a
    cell that does not apply."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        return None, None, {"skipped": reason}
    sh = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(cfg, mesh)
    t0 = time.time()
    model = build_model(cfg, device="meta")
    aparams = abstract_params(cfg)
    psh = tree_param_shardings(aparams, model.logical_axes(), rules)
    specs = input_specs(cfg, shape_name)
    bsh = batch_shardings(specs, rules)
    args = {"params": (aparams, psh), "batch": (specs, bsh)}
    if sh.kind == "train":
        moment = getattr(torch, AdamWConfig().moment_dtype)
        for k in ("mu", "nu"):
            args[k] = (pytree.tree_map(lambda p: torch.empty(
                p.shape, dtype=moment, device="meta"), aparams), psh)
        args["step"] = (torch.empty((), dtype=torch.int32, device="meta"),
                        Placement(mesh, ()))
    elif sh.kind == "decode":
        acache = abstract_cache(cfg, shape_name)
        cax = model.cache_logical_axes(acache)
        args["cache"] = (acache, {k: Placement(mesh, spec_for(
            v.shape, cax[k], rules.act, mesh)) for k, v in acache.items()})
    axes = bsh["tokens"].spec[0]
    axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
    split = math.prod(mesh.shape[a] for a in axes)
    lowered = Lowered(cfg, sh, mesh, args, split)
    t_place = time.time() - t0
    counted = _run_step(lowered)
    meta = {"t_place_s": round(t_place, 2),
            "t_run_s": round(counted.t_run_s, 2)}
    return lowered, counted, meta


def analyze(lowered: Lowered, counted: Counted, cfg, shape_name, mesh_name,
            n_chips) -> dict:
    arg = lowered.argument_bytes()
    live = arg + counted.temp_bytes
    model_ways = lowered.mesh.shape.get("model", 1)
    return {
        "arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips,
        "memory": {"argument_size_in_bytes": arg,
                   "temp_size_in_bytes": counted.temp_bytes},
        "temp_method": TEMP_METHOD,
        "live_bytes_per_device": live,
        "fits_hbm_80g": bool(live <= HBM_PER_CARD),
        "hbm_per_card": HBM_PER_CARD,
        "model_flops_global": model_flops(cfg, shape_name),
        "param_count": param_count(cfg),
        "batch_split": lowered.batch_split,
        "per_device_batch": lowered.shape.batch // lowered.batch_split,
        "flops_counted": counted.flops,
        "flops_by_op": counted.by_op,
        "flops_per_device": counted.flops / model_ways,
        "flops_global": counted.flops * lowered.batch_split,
        "cost_method": COST_METHOD,
        "hlo_bytes_per_device": None,
        "hlo_bytes_reason": NO_BYTES,
        "collective_bytes_per_device": None,
        "collectives_reason": NO_COLLECTIVES,
    }


def run_cell(arch, shape_name, multi_pod, outdir, overrides=None,
             tag="", optimized=False):
    if optimized:
        from repro_torch.configs.registry import OPTIMIZED_OVERRIDES
        overrides = dict(OPTIMIZED_OVERRIDES.get(arch, {}),
                         **(overrides or {}))
        tag = tag + "__opt"
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}{tag}"
    path = os.path.join(outdir, cell + ".json")
    if os.path.exists(path):
        print(f"[skip-cached] {cell}")
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    try:
        lowered, counted, meta = lower_cell(arch, shape_name, multi_pod,
                                            overrides)
        if lowered is None:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "skipped": meta["skipped"]}
            print(f"[skip] {cell}: {meta['skipped']}")
        else:
            n_chips = lowered.mesh.size
            rec = analyze(lowered, counted, cfg, shape_name, mesh_name,
                          n_chips)
            rec.update(meta)
            mem = rec["memory"]
            print(f"[ok] {cell}:"
                  f" mem(arg={mem['argument_size_in_bytes'] / 2**30:.2f}"
                  f"+tmp={mem['temp_size_in_bytes'] / 2**30:.2f} GiB,"
                  f" fits80g={rec['fits_hbm_80g']})"
                  f" run={meta['t_run_s']}s"
                  f" flops/dev={rec['flops_per_device']:.3e}"
                  f" model_flops={rec['model_flops_global']:.3e}")
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        print(f"[FAIL] {cell}: {rec['error']}")
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the per-arch §Perf winning knob sets")
    ap.add_argument("--outdir", default=RESULTS)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.outdir,
                               optimized=args.optimized)
                failures += 1 if "error" in rec else 0
    print(f"done; failures={failures}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
