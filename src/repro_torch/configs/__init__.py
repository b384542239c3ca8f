"""The --arch registry, the zoo's configs, the paper's own workload
(``radic_paper``) and the dry run's shapes.  Port of ``repro/configs``."""

from .registry import ARCHS, OPTIMIZED_OVERRIDES, get_config, list_archs
from .shapes import SHAPES, applicable, input_specs, model_flops

__all__ = ["ARCHS", "OPTIMIZED_OVERRIDES", "get_config", "list_archs",
           "SHAPES", "applicable", "input_specs", "model_flops"]
