"""Atomic, elastic checkpointing of torch pytrees.

Port of ``repro/checkpoint/manager.py``, on the reference's on-disk format,
so each restores what the other wrote, bit for bit:

    step_000123/
      manifest.json     (step, leaf names, shapes, numpy dtype names)
      host_0.npz        (the leaves as ``arr_0``, ``arr_1``, ...)
    LATEST              (atomic pointer file)

* **atomic**: written to ``.tmp-`` then ``os.replace``d, so a crash mid-save
  never corrupts the latest checkpoint;
* **elastic**: the manifest stores only the *logical* tree; ``restore``
  places it on whatever device the caller names (the reference's
  ``shardings`` waits for the mesh module);
* **async**: ``save_async`` copies every leaf to host memory synchronously
  (a CPU tensor is cloned, so a later in-place update cannot leak into the
  write) and writes in a background thread.

Trees flatten through ``torch.utils._pytree`` in jax's order: a plain
dict's keys sorted, ``None`` an empty subtree, and each leaf named by its
path's ``.key``/``.idx`` as the reference's ``_flatten`` does.  Leaves are
torch tensors, numpy arrays or Python scalars.  ``bfloat16`` has no numpy
dtype without ``ml_dtypes``: its bits are stored as ``int16`` under the
manifest dtype ``"bfloat16"`` and read back exactly by this module (the
reference cannot read such a leaf).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["CheckpointManager", "CheckpointMismatchError", "sweep_stale_tmp"]


class CheckpointMismatchError(ValueError):
    """Restore target tree disagrees with the checkpoint manifest.

    Raised (never ``assert``ed — asserts vanish under ``python -O``)
    when leaf names, shapes, or dtypes of the ``like`` tree do not
    match what the manifest recorded at save time.
    """


def sweep_stale_tmp(directory: str) -> list:
    """Remove leftover ``.tmp-*`` write dirs from a crashed save.

    A save that died between ``np.savez`` and ``os.replace`` leaves its
    ``.tmp-<tag>`` directory behind; the gc pass only matches finalized
    tags, so without this sweep they accumulate forever.  Called on
    manager/store init — by construction no writer is in flight then.
    Returns the swept names (for logging/tests).
    """
    swept = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return swept
    for d in entries:
        p = os.path.join(directory, d)
        if d.startswith(".tmp-") and os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
            swept.append(d)
    return swept


def _jax_order(tree):
    """The tree with every plain dict's keys sorted, as jax flattens it
    (torch's pytree keeps insertion order)."""
    if type(tree) is dict:
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_jax_order(v) for v in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_order(v) for v in tree))
    return tree


def _flatten(tree):
    """``(names, leaves, none_slots, spec)``: ``None`` leaves are left out
    of names and leaves (jax has no leaf there) and put back by slot."""
    flat, spec = pytree.tree_flatten_with_path(_jax_order(tree))
    names, vals, nones = [], [], []
    for i, (path, v) in enumerate(flat):
        if v is None:
            nones.append(i)
            continue
        names.append("/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path))
        vals.append(v)
    return names, vals, nones, spec


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _to_host(v) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array that no later update of ``v`` can reach,
    and its manifest dtype name."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.array(v, copy=True)
    return arr, arr.dtype.name


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        sweep_stale_tmp(directory)
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = True):
        names, vals, _, _ = _flatten(tree)
        host = [_to_host(v) for v in vals]

        def write():
            tag = f"step_{step:08d}"
            tmp = os.path.join(self.dir, f".tmp-{tag}")
            final = os.path.join(self.dir, tag)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "host_0.npz"),
                     **{f"arr_{i}": a for i, (a, _) in enumerate(host)})
            manifest = {
                "step": step,
                "names": names,
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [d for _, d in host],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            with open(os.path.join(self.dir, ".LATEST.tmp"), "w") as f:
                f.write(tag)
            os.replace(os.path.join(self.dir, ".LATEST.tmp"),
                       os.path.join(self.dir, "LATEST"))
            self._gc()

        # never let two writers touch the same tmp dir (e.g. an async save
        # of step N still in flight when a blocking save of N arrives)
        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree: Any):
        self.save(step, tree, blocking=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        # LATEST holds the most *recently written* tag, which is not
        # necessarily the lexically-last step (an out-of-order low-step
        # save can land after a higher one) — never delete its target.
        latest = self._latest_tag()
        for d in steps[:-self.keep]:
            if d == latest:
                continue
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def _latest_tag(self) -> str | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return f.read().strip()

    def latest_step(self) -> int | None:
        tag = self._latest_tag()
        if tag is None or not os.path.isdir(os.path.join(self.dir, tag)):
            return None
        return int(tag.split("_")[1])

    def restore(self, like: Any, step: int | None = None,
                device=None) -> tuple[int, Any] | None:
        """Restore into the structure of ``like`` (a pytree of tensors,
        arrays or anything with ``shape`` and ``dtype``, e.g. tensors on
        the ``meta`` device).  Every leaf comes back as a tensor: on
        ``device`` when given, else where its ``like`` leaf lies (the
        CPU for a leaf that is not a tensor)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        tag = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(tag, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(tag, "host_0.npz")) as data:
            vals = [data[f"arr_{i}"] for i in range(len(manifest["names"]))]
        names, like_vals, nones, spec = _flatten(like)
        if names != manifest["names"]:
            raise CheckpointMismatchError(
                "checkpoint/param tree name mismatch:\n"
                f"ckpt: {manifest['names'][:5]}...\nlike: {names[:5]}...")
        # Names alone pass a transposed-leaf corruption — check each
        # target leaf's shape and dtype against the manifest too.
        for name, lv, shape, dtype in zip(
                names, like_vals, manifest["shapes"], manifest["dtypes"]):
            l_shape = getattr(lv, "shape", None)
            l_dtype = getattr(lv, "dtype", None)
            if l_shape is None or l_dtype is None:
                continue    # bare python leaf: nothing to validate
            if list(l_shape) != list(shape) or _dtype_name(l_dtype) != dtype:
                raise CheckpointMismatchError(
                    f"checkpoint leaf {name!r}: checkpoint has "
                    f"shape={tuple(shape)} dtype={dtype}, restore target "
                    f"expects shape={tuple(l_shape)} dtype={l_dtype}")
        leaves = []
        for v, dtype, lv in zip(vals, manifest["dtypes"], like_vals):
            t = _from_host(v, dtype)
            target = device if device is not None else (
                lv.device if isinstance(lv, torch.Tensor)
                and lv.device.type != "meta" else None)
            leaves.append(t if target is None else t.to(target))
        for i in nones:
            leaves.insert(i, None)
        return step, pytree.tree_unflatten(leaves, spec)
