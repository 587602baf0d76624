"""The model zoo's decoder stack for the port's serving (dense and
paged decode) and training paths (rwkv, RG-LRU, global and
sliding-window attention blocks, MLP or mixture-of-experts
feed-forwards), with the reference's configuration class and
converters for its parameters, caches and train states.  The block
modules (`attention`, `rglru`, `moe`, `rwkv`) hold the layers."""
from .config import ModelConfig
from .convert import (
    cache_from_reference, params_from_reference, state_from_reference,
)
from .model import (
    Transformer, decode_step, forward, init_cache, init_paged_cache, loss_fn,
    paged_decode_step, param_dict,
)

__all__ = [
    "ModelConfig",
    "Transformer",
    "cache_from_reference",
    "decode_step",
    "forward",
    "init_cache",
    "init_paged_cache",
    "loss_fn",
    "paged_decode_step",
    "param_dict",
    "params_from_reference",
    "state_from_reference",
]
