"""Parameter descriptors and the basic layers the rwkv serving path needs.

A model is declared once as a tree of `P_` descriptors (shape, init,
scale, dtype).  The tree gives the parameter count without allocating
anything, builds the model's parameters on the meta device, and draws
them from an explicit `torch.Generator` with the reference's standard
deviations (the draws are not jax.random's).  Mesh partition specs, RoPE
and the MLPs are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["P_", "count_params", "rms_norm", "layer_norm", "dense", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class P_:
    """Parameter descriptor: shape, init kind, scale, dtype override."""

    shape: tuple[int, ...]
    init: str = "fan_in"     # fan_in | zeros | ones | normal | embed
    scale: float = 1.0
    dtype: Optional[str] = None  # override model dtype (e.g. fp32 norms)

    def resolve_dtype(self, default_dtype: torch.dtype) -> torch.dtype:
        return DTYPES[self.dtype] if self.dtype else default_dtype

    def std(self) -> float:
        """The normal draw's standard deviation (for init "normal",
        "embed" and "fan_in")."""
        if self.init == "embed":
            return 1.0
        if self.init == "normal":
            return self.scale
        fan_in = self.shape[0] if len(self.shape) >= 2 else max(self.shape[-1], 1)
        if len(self.shape) == 3:  # (heads, in, out) style or (E, in, out)
            fan_in = self.shape[1]
        return self.scale / math.sqrt(fan_in)

    def initialize_(self, out: torch.Tensor, generator: torch.Generator):
        """Fill `out` in place: zeros, ones, or an f32 normal draw times
        `std()` cast to out's dtype."""
        if self.init == "zeros":
            return out.zero_()
        if self.init == "ones":
            return out.fill_(1.0)
        draw = torch.randn(self.shape, generator=generator, device=out.device,
                           dtype=torch.float32)
        return out.copy_(draw * self.std())


def count_params(tree) -> int:
    if isinstance(tree, P_):
        return math.prod(tree.shape)
    values = tree.values() if isinstance(tree, dict) else tree
    return sum(count_params(v) for v in values)


# ----------------------------- layers ---------------------------------


def rms_norm(x, scale, eps):
    """Mean square in f32; the factor and the scale in x's dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    factor = torch.rsqrt(var + eps).to(x.dtype)
    return x * factor * (1.0 + scale).to(x.dtype)


def layer_norm(x, scale, bias, eps):
    """Statistics in f32; the centring and the factor in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True) - mu.square()
    factor = torch.rsqrt(var + eps)
    out = (x - mu.to(x.dtype)) * factor.to(x.dtype)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


def dense(x, w):
    """x: (..., in), w: (in, out) in the model dtype."""
    return torch.matmul(x, w)
