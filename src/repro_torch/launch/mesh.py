"""Production meshes and the sharding rules for a model config on one.

Port of ``repro/launch/mesh.py``.  Functions, not module-level
constants, so importing this module never touches device state.  The
production mesh is a grid of ``meta`` devices: no machine of the port
holds 256 cards, and what reads it (the dry run) reads only
``mesh.shape``; the reference forces 512 host devices for the same end.
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "make_rules"]


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod.  Every
    position of the grid is ``torch.device("meta")``."""
    import numpy as np
    import torch

    from repro_torch.core.distributed import Mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, torch.device("meta"), dtype=object), axes)


def make_rules(cfg, mesh, *, log_fallbacks: bool = False):
    """ShardingRules for a model config on a mesh (FSDP-over-pod for the
    405B-class configs, see ModelConfig.fsdp_over_pod)."""
    from repro_torch.parallel.sharding import (ACT_RULES_LARGE,
                                               ACT_RULES_SMALL,
                                               PARAM_RULES_LARGE,
                                               PARAM_RULES_SMALL,
                                               ShardingRules)
    large = getattr(cfg, "fsdp_over_pod", False)
    act = dict(ACT_RULES_LARGE if large else ACT_RULES_SMALL)
    if getattr(cfg, "seq_shard", False):
        act["seq"] = "model"  # sequence-parallel residual activations
    return ShardingRules(
        mesh=mesh,
        act=act,
        params=PARAM_RULES_LARGE if large else PARAM_RULES_SMALL,
        log_fallbacks=log_fallbacks,
    )
