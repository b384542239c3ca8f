"""AdamW and its learning-rate schedules.  Port of ``repro/optim``."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import constant, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "constant", "warmup_cosine"]
