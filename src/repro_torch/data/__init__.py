"""Deterministic token streams for training (numpy)."""
from .pipeline import (
    MemmapCorpus, SyntheticLM, shard_batch, write_synthetic_corpus,
)

__all__ = ["MemmapCorpus", "SyntheticLM", "shard_batch",
           "write_synthetic_corpus"]
