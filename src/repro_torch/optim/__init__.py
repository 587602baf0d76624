"""The reference's optimizers on dicts of tensors."""
from .optimizers import (
    Optimizer, adafactor, adamw, apply_updates, clip_by_global_norm,
    cosine_schedule, global_norm, make_optimizer, sgdm,
)

__all__ = [
    "Optimizer", "adafactor", "adamw", "apply_updates",
    "clip_by_global_norm", "cosine_schedule", "global_norm",
    "make_optimizer", "sgdm",
]
