"""Parameter descriptors and the basic layers of the serving path:
norms, dense products, RoPE / M-RoPE and the MLPs.

A model is declared once as a tree of `P_` descriptors (shape, init,
scale, dtype).  The tree gives the parameter count without allocating
anything, builds the model's parameters on the meta device, and draws
them from an explicit `torch.Generator` with the reference's standard
deviations (the draws are not jax.random's).  Mesh partition specs have
no role on one card and are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["P_", "count_params", "rms_norm", "layer_norm", "dense", "rope",
           "mrope", "mlp_params", "mlp", "DTYPES"]

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


def _rope_freq(half: int, theta: float, device):
    """theta ** (-i / half) for i < half, f32.  The exponent is the f32
    quotient; the power is taken in f64 and rounded once, which is the
    f32 value XLA gives (torch's f32 pow is an ulp off at some i, and
    an ulp of a frequency is 1e-4 of a radian by position 4096)."""
    expo = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return (theta ** expo.double()).float()


def _rope_angles(positions, dims, theta):
    """positions: (..., S) int; returns cos/sin (..., S, dims//2) f32."""
    freq = _rope_freq(dims // 2, theta, positions.device)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Rotate the halves (x1, x2) of x's last axis by the angles, in f32;
    the result in x's dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta):
    """x: (B, H, S, D); positions: (B, S).  Rotates the pairs (x[i],
    x[i + D/2]) of the two halves, as the reference does."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, S, D/2)
    return _rotate(x, cos[:, None], sin[:, None])


def mrope(x, positions, theta, sections):
    """Multimodal RoPE (qwen2-vl): positions (B, S, 3) = (t, h, w) ids;
    the D/2 rotary frequencies are split into 3 sections, each rotated
    by its own position stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freq = _rope_freq(half, theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device))            # (half,)
    pos = positions.float()                                     # (B, S, 3)
    ang = pos[..., sec_id] * freq                               # (B, S, half)
    return _rotate(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


# ------------------------------- MLP -----------------------------------


def mlp_params(d_model: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "wi": P_((d_model, d_ff)),
            "wg": P_((d_model, d_ff)),
            "wo": P_((d_ff, d_model)),
        }
    return {  # plain gelu (whisper)
        "wi": P_((d_model, d_ff)),
        "wo": P_((d_ff, d_model)),
    }


def mlp(x, params, kind: str):
    """swiglu, geglu or plain gelu; gelu is the tanh approximation."""
    if kind == "swiglu":
        return dense(F.silu(dense(x, params["wg"])) * dense(x, params["wi"]),
                     params["wo"])
    if kind == "geglu":
        return dense(F.gelu(dense(x, params["wg"]), approximate="tanh")
                     * dense(x, params["wi"]), params["wo"])
    return dense(F.gelu(dense(x, params["wi"]), approximate="tanh"),
                 params["wo"])
