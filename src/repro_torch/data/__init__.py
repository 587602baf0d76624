"""Deterministic token streams for training (numpy)."""
from .pipeline import MemmapCorpus, SyntheticLM, write_synthetic_corpus

__all__ = ["MemmapCorpus", "SyntheticLM", "write_synthetic_corpus"]
