from .ops import pair_apply
from .ref import pair_apply_ref

__all__ = ["pair_apply", "pair_apply_ref"]
