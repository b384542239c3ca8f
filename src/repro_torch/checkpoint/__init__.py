"""Checkpoints of torch pytrees and the durable plan store.  Port of
``repro/checkpoint``."""

from .manager import (CheckpointManager, CheckpointMismatchError,
                      sweep_stale_tmp)
from .plan_store import PlanStore

__all__ = ["CheckpointManager", "CheckpointMismatchError",
           "sweep_stale_tmp", "PlanStore"]
