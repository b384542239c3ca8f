"""Carry a reference parameter tree or KV cache into the port and back.

The reference (``repro.models.lm.CausalLM``) keeps its params as a tree
of arrays with the layer params stacked on a leading ``(L, ...)`` dim;
the port's :class:`~repro_torch.models.lm.CausalLM` keeps one module per
layer.  Both hold weights as ``(in, out)``, so a leaf moves by a copy:
:func:`params_from_reference` slices each stacked leaf into the layers,
:func:`params_to_reference` stacks them back, and a round trip returns
the same bits.  Leaves are numpy arrays (anything ``np.asarray``
takes); a ``bfloat16`` leaf (``ml_dtypes``' dtype, which jax arrays
convert to) moves as its 16-bit pattern, and writing one back needs
``ml_dtypes`` for the numpy dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .lm import CausalLM

__all__ = ["params_from_reference", "params_to_reference",
           "load_reference", "cache_from_reference", "cache_to_reference"]


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise TypeError("a bfloat16 leaf needs ml_dtypes for its numpy "
                            "dtype") from e
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _copy(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(f"{name}: reference leaf {tuple(src.shape)} "
                         f"{src.dtype} for a {tuple(dst.shape)} {dst.dtype} "
                         "param")
    dst.copy_(src)


def _same_keys(have, want, where: str) -> None:
    if set(have) != set(want):
        raise ValueError(f"{where}: reference keys {sorted(have)} != "
                         f"{sorted(want)}")


@torch.no_grad()
def load_reference(model: CausalLM, tree) -> CausalLM:
    """Copy a reference param tree into ``model``'s params (same shapes
    and dtypes, else ``ValueError``)."""
    dev = model.device
    top = {k: v for k, v in model.named_parameters(recurse=False)}
    _same_keys(tree.keys(), [*top, "layers"], "params")
    for name, p in top.items():
        _copy(p, _to_torch(tree[name], dev), name)
    layers = tree["layers"]
    want = model.layers[0].tree() if len(model.layers) else {}
    _same_keys(layers.keys(), want.keys(), "layers")
    for key, sub in want.items():
        if isinstance(sub, dict):
            _same_keys(layers[key].keys(), sub.keys(), f"layers.{key}")
            leaves = {f"{key}.{k}": layers[key][k] for k in sub}
        else:
            leaves = {key: layers[key]}
        for path, stacked in leaves.items():
            stacked = _to_torch(stacked, dev)
            if stacked.shape[0] != len(model.layers):
                raise ValueError(f"layers.{path}: {stacked.shape[0]} "
                                 f"stacked layers for {len(model.layers)}")
            for i, layer in enumerate(model.layers):
                _copy(layer.get_parameter(path), stacked[i],
                      f"layers.{path}[{i}]")
    return model


def params_from_reference(cfg: ModelConfig, tree, device="cuda"
                          ) -> CausalLM:
    """A :class:`CausalLM` on ``device`` holding the reference tree's
    params."""
    return load_reference(CausalLM(cfg, device=device), tree)


def params_to_reference(model: CausalLM) -> dict:
    """``model``'s params as the reference's tree of numpy arrays (layer
    params stacked on a leading ``(L, ...)`` dim)."""
    tree: dict = {name: _to_numpy(p)
                  for name, p in model.named_parameters(recurse=False)}
    trees = [layer.tree() for layer in model.layers]
    layers: dict = {}
    for key, sub in trees[0].items():
        if isinstance(sub, dict):
            layers[key] = {k: np.stack([_to_numpy(t[key][k]) for t in trees])
                           for k in sub}
        else:
            layers[key] = np.stack([_to_numpy(t[key]) for t in trees])
    tree["layers"] = layers
    return tree


def cache_from_reference(cache, device="cuda") -> dict:
    """A reference KV cache (``k``/``v`` ``(L, B, T, KVH, D)``, scalar
    ``pos``) as the port's, on ``device``."""
    _same_keys(cache.keys(), ["k", "v", "pos"], "cache")
    out = {k: _to_torch(cache[k], device) for k in ("k", "v")}
    out["pos"] = _to_torch(np.asarray(cache["pos"], np.int32), device)
    return out


def cache_to_reference(cache) -> dict:
    """The port's KV cache as the reference's tree of numpy arrays."""
    return {k: _to_numpy(cache[k]) for k in ("k", "v", "pos")}
