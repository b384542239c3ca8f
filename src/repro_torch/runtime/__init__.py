"""Runtime health and elasticity for the serving tier: the heartbeat
watchdog and step-time straggler detector, the speculative grain
scheduler, and the elastic grid rule.  Port of ``repro/runtime`` without
its jax-importing mesh builder."""

from .elastic import MeshPlan, choose_mesh
from .stragglers import run_grains
from .watchdog import StepTimer, Watchdog

__all__ = ["MeshPlan", "choose_mesh", "run_grains", "StepTimer", "Watchdog"]
