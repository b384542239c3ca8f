"""Carry a reference parameter tree or cache into the port and back.

The reference (``repro.models.lm.CausalLM`` and
``repro.models.encdec.EncDecLM``) keeps its params as a tree of arrays
with the layer params stacked on a leading ``(L, ...)`` dim (``layers``;
``enc_layers`` and ``dec_layers`` for the encoder–decoder), nested as
the family nests them (``layers.moe.dense.w_gate``,
``layers.mix.attn.wq``); the port keeps one module per layer.  Both hold
weights as ``(in, out)``, so a leaf moves by a copy:
:func:`params_from_reference` slices each stacked leaf into the layers,
:func:`params_to_reference` stacks them back, and a round trip returns
the same bits.  Caches move whole: any of the reference's key sets
(``k``/``v``, ``conv``/``state``, both, or ``k``/``v``/``ck``/``cv``;
with ``pos``).  Leaves are numpy arrays (anything ``np.asarray``
takes); a ``bfloat16`` leaf (``ml_dtypes``' dtype, which jax arrays
convert to) moves as its 16-bit pattern, and writing one back needs
``ml_dtypes`` for the numpy dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from torch import nn

from .config import ModelConfig

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


def _flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict as {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _check_nesting(have: dict, want: dict, where: str) -> None:
    _same_keys(have.keys(), want.keys(), where)
    for k, sub in want.items():
        if isinstance(sub, dict):
            if not isinstance(have[k], dict):
                raise ValueError(f"{where}.{k}: a leaf where the port has "
                                 "a dict")
            _check_nesting(have[k], sub, f"{where}.{k}")


def _stacks(model: nn.Module) -> dict[str, nn.ModuleList]:
    """The model's stacked layer lists by their reference names."""
    return {name: mod for name, mod in model.named_children()
            if isinstance(mod, nn.ModuleList)}


@torch.no_grad()
def load_reference(model: nn.Module, tree) -> nn.Module:
    """Copy a reference param tree into ``model``'s params (same keys at
    every level, shapes and dtypes, else ``ValueError``)."""
    dev = model.device
    top = {k: v for k, v in model.named_parameters(recurse=False)}
    stacks = _stacks(model)
    _same_keys(tree.keys(), [*top, *stacks], "params")
    for name, p in top.items():
        _copy(p, _to_torch(tree[name], dev), name)
    for lname, layers in stacks.items():
        if not len(layers):
            continue
        want: dict = layers[0].tree()
        _check_nesting(tree[lname], want, lname)
        for path, stacked in _flatten(tree[lname]).items():
            stacked = _to_torch(stacked, dev)
            if stacked.shape[0] != len(layers):
                raise ValueError(f"{lname}.{path}: {stacked.shape[0]} "
                                 f"stacked layers for {len(layers)}")
            for i, layer in enumerate(layers):
                _copy(layer.get_parameter(path), stacked[i],
                      f"{lname}.{path}[{i}]")
    return model


def params_from_reference(cfg: ModelConfig, tree, device="cuda"
                          ) -> nn.Module:
    """The family's model (``build_model``) on ``device`` holding the
    reference tree's params."""
    from . import build_model
    return load_reference(build_model(cfg, device=device), tree)


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def params_to_reference(model: nn.Module) -> dict:
    """``model``'s params as the reference's tree of numpy arrays (layer
    params stacked on a leading ``(L, ...)`` dim, nested as the
    reference nests them)."""
    tree: dict = {name: _to_numpy(p)
                  for name, p in model.named_parameters(recurse=False)}
    for lname, layers in _stacks(model).items():
        flats = [_flatten(layer.tree()) for layer in layers]
        tree[lname] = _unflatten({
            path: np.stack([_to_numpy(f[path]) for f in flats])
            for path in flats[0]})
    return tree


# the reference's cache layouts: attention, ssm, hybrid, encoder-decoder
CACHE_KEYS = ({"k", "v"}, {"conv", "state"}, {"k", "v", "conv", "state"},
              {"k", "v", "ck", "cv"})


def _cache_keys(cache) -> list[str]:
    keys = set(cache.keys()) - {"pos"}
    if "pos" not in cache or keys not in CACHE_KEYS:
        raise ValueError(f"cache: reference keys {sorted(cache.keys())} are "
                         "none of the layouts "
                         f"{[sorted(k | {'pos'}) for k in CACHE_KEYS]}")
    return sorted(keys)


def cache_from_reference(cache, device="cuda") -> dict:
    """A reference cache (``k``/``v`` ``(L, B, T, KVH, D)``, ``conv``
    ``(L, B, K-1, C)`` and ``state`` ``(L, B, H, P, N)``, ``ck``/``cv``
    ``(L, B, n_frames, KVH, D)``, and a scalar ``pos``) as the port's, on
    ``device``."""
    out = {k: _to_torch(cache[k], device) for k in _cache_keys(cache)}
    out["pos"] = _to_torch(np.asarray(cache["pos"], np.int32), device)
    return out


def cache_to_reference(cache) -> dict:
    """The port's cache as the reference's tree of numpy arrays."""
    return {k: _to_numpy(cache[k]) for k in [*_cache_keys(cache), "pos"]}
