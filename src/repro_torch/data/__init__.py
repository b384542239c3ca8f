"""Training data: the synthetic LM stream and its prefetcher.  Port of
``repro/data``."""

from .pipeline import DataConfig, Prefetcher, SyntheticLMData

__all__ = ["DataConfig", "Prefetcher", "SyntheticLMData"]
