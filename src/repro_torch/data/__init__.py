"""Deterministic synthetic data (the reference's ``data/pipeline.py``)."""
from .pipeline import DataConfig, SyntheticTokens, make_batch_fn

__all__ = ["DataConfig", "SyntheticTokens", "make_batch_fn"]
