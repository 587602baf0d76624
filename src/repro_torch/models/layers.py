"""Parameter descriptors and the basic layers of the serving path:
norms, dense products, RoPE / M-RoPE and the MLPs.

A model is declared once as a tree of `P_` descriptors (shape, init,
scale, dtype, partition spec).  The tree gives the parameter count
without allocating anything, builds the model's parameters on the meta
device (`abstract_tree`), gives the tree of partition specs
(`spec_tree`), and draws the parameters from an explicit
`torch.Generator` with the reference's standard deviations (the draws
are not jax.random's).

A spec is the reference's `PartitionSpec` as a plain tuple: one entry
per dim, a mesh dim name, a tuple of names, or None (replicated).  Two
logical dims shard parameters: "data" (FSDP / ZeRO-3: gathered at use)
and "model" (tensor parallel: heads, d_ff and the vocabulary); the
multi-pod "pod" dim replicates them and splits only the batch.
`current_mesh()` is the mesh that `launch.mesh.set_mesh` put in
context; under it the model's entry points run sharded when called with
`dp=` (`models.sharded`).  The reference's `constrain_act` is not
ported: it only hints a layout to GSPMD, and here the layout is written
out in `models.sharded`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..launch.mesh import active_mesh

__all__ = ["P_", "count_params", "spec_tree", "abstract_tree",
           "current_mesh", "rms_norm", "layer_norm", "dense", "rope",
           "mrope", "mlp_params", "mlp", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class P_:
    """Parameter descriptor: shape, init kind, scale, dtype override and
    partition spec (module docstring; () is replicated)."""

    shape: tuple[int, ...]
    init: str = "fan_in"     # fan_in | zeros | ones | normal | embed
    scale: float = 1.0
    dtype: Optional[str] = None  # override model dtype (e.g. fp32 norms)
    spec: tuple = ()

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


def _map(fn, tree):
    """`fn` of every `P_` of a tree of dicts and lists, in its shape."""
    if isinstance(tree, P_):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return [_map(fn, v) for v in tree]


def count_params(tree) -> int:
    if isinstance(tree, P_):
        return math.prod(tree.shape)
    values = tree.values() if isinstance(tree, dict) else tree
    return sum(count_params(v) for v in values)


def spec_tree(tree):
    """The partition specs of a descriptor tree, in its shape."""
    return _map(lambda d: d.spec, tree)


def abstract_tree(tree, dtype: torch.dtype):
    """Meta tensors (nothing allocated) of a descriptor tree, in its
    shape, each in its descriptor's dtype or `dtype`."""
    return _map(lambda d: torch.empty(d.shape, dtype=d.resolve_dtype(dtype),
                                      device="meta"), tree)


def current_mesh():
    """The mesh in context (`launch.mesh.set_mesh`), or None."""
    return active_mesh()


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
    # each frequency's section, from the host's sizes (no size here
    # depends on a tensor's values)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    pos = positions.float()                                     # (B, S, 3)
    ang = pos[..., sec_id] * freq                               # (B, S, half)
    return _rotate(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


# ------------------------------- MLP -----------------------------------


def mlp_params(d_model: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "wi": P_((d_model, d_ff), spec=("data", "model")),
            "wg": P_((d_model, d_ff), spec=("data", "model")),
            "wo": P_((d_ff, d_model), spec=("model", "data")),
        }
    return {  # plain gelu (whisper)
        "wi": P_((d_model, d_ff), spec=("data", "model")),
        "wo": P_((d_ff, d_model), spec=("model", "data")),
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
