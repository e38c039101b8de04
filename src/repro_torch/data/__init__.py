from .pipeline import DataConfig, MemmapLM, Prefetcher, SyntheticLM, make_source

__all__ = ["DataConfig", "MemmapLM", "Prefetcher", "SyntheticLM",
           "make_source"]
