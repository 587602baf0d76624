"""The TF32 policy shared by the gossip kernels' plain versions and the
model: float32 products run in full f32."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["no_tf32"]


@contextlib.contextmanager
def no_tf32():
    """Run float32 matmuls in full f32 on the card, whatever the global
    TF32 setting (TF32 keeps about three decimal digits)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
