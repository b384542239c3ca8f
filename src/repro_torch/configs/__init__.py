"""The --arch registry, the zoo's configs and the paper's own workload
(``radic_paper``).  Port of ``repro/configs``; ``shapes.py`` (the
dry-run's abstract shapes) is not ported yet."""

from .registry import ARCHS, OPTIMIZED_OVERRIDES, get_config, list_archs

__all__ = ["ARCHS", "OPTIMIZED_OVERRIDES", "get_config", "list_archs"]
