"""Runtime health and elasticity for the serving tier: the heartbeat
watchdog and step-time straggler detector, the speculative grain
scheduler, and the elastic grid rule with its mesh builder.  Port of
``repro/runtime``."""

from .elastic import MeshPlan, build_mesh, choose_mesh
from .stragglers import run_grains
from .watchdog import StepTimer, Watchdog

__all__ = ["MeshPlan", "build_mesh", "choose_mesh", "run_grains",
           "StepTimer", "Watchdog"]
