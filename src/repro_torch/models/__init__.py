"""The model zoo's decoder stack for the port's serving path (rwkv and
dense attention blocks), with the reference's configuration class and a
converter for its parameters and caches."""
from .config import ModelConfig
from .convert import cache_from_reference, params_from_reference
from .model import Transformer, decode_step, forward, init_cache

__all__ = [
    "ModelConfig",
    "Transformer",
    "cache_from_reference",
    "decode_step",
    "forward",
    "init_cache",
    "params_from_reference",
]
