from .registry import ARCH_IDS, SHAPES, get_config, reduce_config

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "reduce_config"]
