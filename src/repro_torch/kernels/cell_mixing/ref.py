"""Plain PyTorch version of the cell-mixing kernel: ``W^rounds @ x``
in full f32 (TF32 off)."""
from __future__ import annotations

import torch

from ..._tf32 import no_tf32

__all__ = ["cell_mixing_ref"]


def cell_mixing_ref(w, x, *, rounds: int = 1):
    """y[b] = W[b]^rounds @ x[b], accumulated in f32."""
    y = x.float()
    wf = w.float()
    with no_tf32():
        for _ in range(rounds):
            y = torch.matmul(wf, y)
    return y.to(x.dtype)
