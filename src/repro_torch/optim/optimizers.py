"""The reference's self-contained optimizers, on dicts of tensors.

* adamw     — f32 moments;
* adafactor — factored second moment (rows + columns of every matrix),
  optional bf16 momentum;
* sgdm      — momentum SGD.

Each is an `Optimizer` of three functions:

  state = init(params)
  updates, state = update(grads, state, params, lr)   # functional
  update_(grads, state, params, lr)                   # in place

`params`, `grads` and the moment trees are flat dicts of tensors, as the
port's train state holds them.  `update` leaves its inputs untouched;
`update_` writes the new moments and parameters into the tensors it is
given, leaf by leaf, so no more than one leaf's temporaries live at a
time (at llama3.2-3b's embedding a full f32 update tree would be 1.6 GB a
copy).  Both run the same per-leaf arithmetic and give the same bits.

With ``stacked=True`` every leaf (and `count`) carries a leading replica
axis R, as the decentralized train state does: each replica row is
updated on its own, as the reference's `jax.vmap` of the optimizer.

With ``sharding=(mesh, specs)`` (a model-sharded train state,
`models.sharded`: `specs` the parameters' sanitized specs by name) each
leaf is this rank's block.  AdamW and SGDM are elementwise and ignore
it.  Adafactor's means over a whole leaf become a local sum, a psum over
exactly the mesh dims that shard the reduced dims (none where the leaf
is replicated), and a division by the global size: the row and column
means of the squared gradient, the row mean in the denominator, and the
update's RMS for the clip.  Its `vr` and `vc` blocks are the ones
`launch.specs.state_shardings` gives.  Without `sharding` the update is
the one-device arithmetic, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..dist import collectives as C
from ..models.sharded import sharded_dims

__all__ = [
    "Optimizer", "adamw", "adafactor", "sgdm",
    "apply_updates", "global_norm", "square_norm", "clip_by_global_norm",
    "cosine_schedule", "make_optimizer",
]

# a leaf's sum of squares runs over pieces of at most this many elements,
# so its f32 copy stays small however large the leaf
_NORM_PIECE = 1 << 27


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # (params, stacked=False) -> state
    # (grads, state, params, lr, stacked=False, sharding=None)
    update: Callable   # -> (updates, state)
    update_: Callable  # -> None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of one leaf in f32."""
    flat = g.reshape(-1)
    if flat.numel() <= _NORM_PIECE:
        return flat.float().square().sum()
    total = None
    for piece in flat.split(_NORM_PIECE):
        s = piece.float().square().sum()
        total = s if total is None else total + s
    return total


def square_norm(tree) -> torch.Tensor:
    """The f32 sum of squares over every leaf (0-d f32)."""
    return sum(_sq_sum(g) for g in _leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf (0-d f32)."""
    return torch.sqrt(square_norm(tree))


def clip_by_global_norm(grads: dict, max_norm: float, *,
                        inplace: bool = False, norm=None):
    """(grads scaled to global norm <= max_norm, the norm before).  The
    scale is cast to each leaf's dtype, as the reference casts it.
    `norm`: the global norm when the caller has it (a sharded step sums
    its blocks' squares over the mesh)."""
    n = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp_min(n, 1e-9), max=1.0)
    if inplace:
        for g in grads.values():
            g.mul_(scale.to(g.dtype))
        return grads, n
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, n


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to `base_lr`, then a half cosine to 0 at `total`.
    lr(step) is a Python float, computed in float32 as the reference
    computes it."""
    f32 = np.float32

    def lr(step) -> float:
        s = f32(int(step))
        if s < warmup:
            return float(f32(base_lr) * s / f32(max(warmup, 1)))
        t = (s - f32(warmup)) / f32(max(total - warmup, 1))
        t = np.minimum(np.maximum(t, f32(0.0)), f32(1.0))
        return float(f32(0.5 * base_lr) * (f32(1.0) + np.cos(f32(np.pi) * t)))
    return lr


def _count(state, stacked: bool, r: int):
    """The step count this update runs at (count + 1), a 0-d int32."""
    c = state["count"]
    return (c[r] if stacked else c) + 1


def _rows(stacked: bool, tree):
    """The replica rows an update loops over: (r, row view getter)."""
    if not stacked:
        return [(None, lambda t: t)]
    R = next(_leaves(tree)).shape[0]
    return [(r, (lambda t, r=r: t[r])) for r in range(R)]


def _build(init_leaf, step_leaf, tree_names) -> Optimizer:
    """An Optimizer from its per-leaf parts.

    init_leaf(p, ndim) -> the leaf's state dict of zeros shaped after p
    (a leaf, or its R rows stacked), `ndim` the dims of one row;
    step_leaf(g, s, p, lr, c, shard) -> u: updates the leaf state dicts
    `s` in place and returns the f32 (or momentum-dtype) update of the
    leaf; `shard` is (mesh, the leaf's spec) for a sharded leaf, else
    None.  tree_names: the names of the state's per-leaf trees.
    """

    def init(params: dict, stacked: bool = False) -> dict:
        state = {name: {} for name in tree_names}
        for k, p in params.items():
            leaf = init_leaf(p, p.dim() - int(stacked))
            for name, v in leaf.items():
                state[name][k] = v
        first = next(iter(params.values()))
        shape = (first.shape[0],) if stacked else ()
        state["count"] = torch.zeros(shape, dtype=torch.int32,
                                     device=first.device)
        return state

    def _leaf_state(state, k, row):
        return {name: _map(row, state[name][k]) for name in tree_names}

    def _shard(sharding, k):
        return None if sharding is None else (sharding[0], sharding[1][k])

    def update_(grads: dict, state: dict, params: dict, lr,
                stacked: bool = False, sharding=None) -> None:
        for r, row in _rows(stacked, params):
            c = _count(state, stacked, r)
            for k, p in params.items():
                u = step_leaf(row(grads[k]), _leaf_state(state, k, row),
                              row(p), lr, c, _shard(sharding, k))
                row(p).add_(u.to(p.dtype))
        state["count"].add_(1)

    def update(grads: dict, state: dict, params: dict, lr,
               stacked: bool = False, sharding=None):
        new = _clone(state)
        updates = {}
        for k, p in params.items():
            outs = []
            for r, row in _rows(stacked, params):
                c = _count(state, stacked, r)
                outs.append(step_leaf(row(grads[k]),
                                      _leaf_state(new, k, row), row(p),
                                      lr, c, _shard(sharding, k)))
            updates[k] = torch.stack(outs) if stacked else outs[0]
        new["count"] = state["count"] + 1
        return updates, new

    return Optimizer(init, update, update_)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _clone(tree):
    return _map(lambda t: t.clone(), tree)


# ------------------------------- adamw --------------------------------


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init_leaf(p, ndim):
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def step_leaf(g, s, p, lr, c, shard):
        gf = g.float()
        m, v = s["m"], s["v"]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf.square())
        del gf
        cf = c.float()
        mh = m / (1 - b1 ** cf)
        vh = v / (1 - b2 ** cf)
        vh.sqrt_().add_(eps)
        mh.div_(vh)
        del vh
        if weight_decay:
            mh.add_(weight_decay * p.float())
        return mh.mul_(-lr)

    return _build(init_leaf, step_leaf, ("m", "v"))


# ----------------------------- adafactor ------------------------------


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, momentum: bool = False,
              momentum_dtype=torch.bfloat16) -> Optimizer:
    """Factored RMS (Shazeer & Stern 2018). For ndim>=2 params keep only
    row/col second-moment vectors over the trailing two dims."""

    def init_leaf(p, ndim):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if ndim >= 2:
            st = {"v": {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}}
        else:
            st = {"v": {"v": z(p.shape)}}
        if momentum:
            st["m"] = torch.zeros(p.shape, dtype=momentum_dtype,
                                  device=p.device)
        return st

    def step_leaf(g, s, p, lr, c, shard):
        beta = 1.0 - (c.float() + 1.0) ** (-decay)
        gf = g.float()
        g2 = gf.square() + eps
        v = s["v"]
        nd = g.dim()
        if "vr" in v:
            v["vr"].copy_(beta * v["vr"] + (1 - beta)
                          * _mean(g2, shard, -1, (nd - 1,)))
            v["vc"].copy_(beta * v["vc"] + (1 - beta)
                          * _mean(g2, shard, -2, (nd - 2,)))
            denom = torch.clamp_min(_mean(v["vr"], shard, -1, (nd - 2,),
                                          keepdim=True), eps)
            rfac = torch.rsqrt(v["vr"] / denom)[..., None]
            cfac = torch.rsqrt(v["vc"])[..., None, :]
            u = gf * rfac * cfac
        else:
            v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
            u = gf * torch.rsqrt(v["v"])
        rms = torch.sqrt(_mean(u.square(), shard, None, range(nd)) + 1e-30)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        u = -lr * u
        if momentum:
            m = s["m"]
            m.copy_((0.9 * m.float() + u).to(m.dtype))
            u = m.float()
        return u

    names = ("v", "m") if momentum else ("v",)
    return _build(init_leaf, step_leaf, names)


def _mean(x, shard, dim, leaf_dims, keepdim: bool = False):
    """The mean of x over its dim `dim` (every dim when None).  With
    `shard` = (mesh, spec), x is a block of a leaf sharded as `spec` and
    `leaf_dims` are the leaf's dims that the mean reduces: the block's
    sum is summed over the mesh dims that shard them and divided by the
    global count."""
    if shard is None:
        if dim is None:
            return x.mean()
        return x.mean(dim, keepdim=keepdim)
    mesh, spec = shard
    axes = sharded_dims(tuple(spec[d] for d in leaf_dims if d < len(spec)))
    if dim is None:
        total, count = x.sum(), x.numel()
    else:
        total, count = x.sum(dim, keepdim=keepdim), x.shape[dim]
    if axes:
        total = C.psum(total, mesh, axes)
        count *= C.axis_size(mesh, axes)
    return total / count


# -------------------------------- sgdm --------------------------------


def sgdm(momentum: float = 0.9) -> Optimizer:
    def init_leaf(p, ndim):
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def step_leaf(g, s, p, lr, c, shard):
        m = s["m"]
        m.mul_(momentum).add_(g.float())
        return -lr * m

    return _build(init_leaf, step_leaf, ("m",))


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgdm":
        return sgdm(**kw)
    raise ValueError(name)
