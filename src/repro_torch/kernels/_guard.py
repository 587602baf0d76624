"""The forward-only kernels refuse autograd.

Each op writes its CUDA kernel's result through ctypes (cell_mixing
through its extension module's entry) into a fresh tensor, which
carries no `grad_fn`: a loss computed through it would silently give
nothing upstream a gradient.  So on any device but the
CPU (whose plain versions are differentiable tensor code) an op raises
before its launch when gradients are on and a floating input asks for
one.  Training takes the differentiable route instead: `full_attention`
and the chunked plain wkv recurrence (`models.model.loss_fn`).
"""
from __future__ import annotations

import torch

__all__ = ["refuse_autograd"]


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if `name`'s kernel would be asked for a gradient."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors
           if torch.is_tensor(t) and t.is_floating_point()):
        raise RuntimeError(
            f"the {name} kernel is forward only: it cannot carry a "
            f"gradient.  Train through models.model.loss_fn, which takes "
            f"the differentiable route (full_attention, the plain wkv "
            f"recurrence), or call the op under torch.no_grad()")
