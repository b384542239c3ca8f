"""Sharding rules for a model config on a mesh.

Port of ``repro/launch/mesh.py``'s :func:`make_rules`.  The production
mesh (``make_production_mesh``) waits for the dry-run slice."""

from __future__ import annotations

__all__ = ["make_rules"]


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
