"""Deterministic synthetic data (the reference's ``data/pipeline.py``)."""
from .pipeline import DataConfig, SyntheticEmbeds, SyntheticTokens, host_corpus, make_batch_fn

__all__ = ["DataConfig", "SyntheticEmbeds", "SyntheticTokens", "host_corpus",
           "make_batch_fn"]
