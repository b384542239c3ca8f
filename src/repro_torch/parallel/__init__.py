"""Parallelism substrate: the logical-axis sharding rules and placements,
the GPipe pipeline and gradient compression.  Port of ``repro/parallel``;
``compat.py`` (shard_map spellings) has no counterpart: the port has no
``shard_map``."""

from .sharding import (Placement, ShardingRules, constraint, current_rules,
                       sharding_for, spec_for, tree_param_shardings,
                       use_rules)
from .pipeline import bubble_fraction, gpipe_schedule, pipeline_apply  # noqa

__all__ = ["Placement", "ShardingRules", "constraint", "current_rules",
           "sharding_for", "spec_for", "tree_param_shardings", "use_rules",
           "bubble_fraction", "gpipe_schedule", "pipeline_apply"]
