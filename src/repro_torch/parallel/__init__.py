"""Parallelism substrate: the logical-axis sharding rules.  Port of
``repro/parallel``; the pipeline and int8 collectives are not ported yet,
and ``compat.py`` (shard_map spellings) has no counterpart."""

from .sharding import (ShardingRules, constraint, current_rules, spec_for,
                       use_rules)

__all__ = ["ShardingRules", "constraint", "current_rules", "spec_for",
           "use_rules"]
