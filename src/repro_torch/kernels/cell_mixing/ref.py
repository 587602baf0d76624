"""Plain PyTorch version of the cell-mixing kernel: ``W^rounds @ x``
in full f32 (TF32 off)."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["cell_mixing_ref", "no_tf32"]


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


def cell_mixing_ref(w, x, *, rounds: int = 1):
    """y[b] = W[b]^rounds @ x[b], accumulated in f32."""
    y = x.float()
    wf = w.float()
    with no_tf32():
        for _ in range(rounds):
            y = torch.matmul(wf, y)
    return y.to(x.dtype)
