"""Train-step builders.

`make_train_step` — one replica on one device: loss and gradients
through `models.loss_fn`, clip by global norm, the optimizer's update.

`make_decentralized_step` — the paper's feature: R parameter replicas
(leading axis R on every leaf of the state) whose gradients are mixed by
a `dist` strategy instead of an exact global all-reduce.  The
`SyncConfig` is resolved ONCE into a static `SyncPlan` when the step is
built; every step then runs `dist.execute_sync(plan, grads, residuals,
step)` — compress (error feedback) -> faults -> rotate (randomized
cells by step index) -> mix.  Exact strategies (allreduce /
hierarchical) keep replicas bitwise identical; gossip strategies bound
the replica disagreement by the mixing rounds (the paper's eps).

Each replica's gradient comes from its own forward and backward on its
row of the state (`replica_grads`), written into its row of one stacked
gradient, so only one replica's activations live at a time.  With
`SyncConfig(overlap="one_step")` the step applies the PREVIOUS step's
mixed gradients while the fresh ones become the in-flight buffer
(`prev_grads`), under the rotation index and learning rate of the step
that produced them; step 0 is warm-up and leaves parameters and
optimizer state untouched.

Both steps update the state IN PLACE (the reference's jit donates it)
and return it with the step's metrics: the llama3.2-3b state is tens of
GB, and a second copy would not fit beside it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .._tf32 import no_tf32
from ..core.options import resolve_device
from ..dist import (
    SyncConfig, build_sync_plan, execute_sync, init_inflight, init_residual,
    plan_wire_bytes, replica_fault_masks,
)
from ..models.config import ModelConfig
from ..models.model import loss_fn, param_dict
from ..optim.optimizers import Optimizer, clip_by_global_norm, global_norm

__all__ = [
    "make_train_step", "make_decentralized_step", "replica_grads",
    "clip_replicas_", "init_train_state", "init_decentralized_state",
    "replicate", "consensus_distance", "survivor_consensus_distance",
]

# consensus distances run over pieces of at most this many elements of a
# leaf (all replica rows together), so their f32 copies stay small
_PIECE = 1 << 26


def _flat(params) -> dict:
    """A `Transformer`'s parameters as a flat dict; a dict as is."""
    return params if isinstance(params, dict) else param_dict(params)


def init_train_state(params, optimizer: Optimizer) -> dict:
    """params: a `Transformer` or a flat dict of tensors (the state holds
    those tensors and updates them in place)."""
    params = _flat(params)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def replicate(params, R: int) -> dict:
    """R copies of the parameters stacked on a leading replica axis."""
    return {k: p.unsqueeze(0).expand((R,) + p.shape).clone()
            for k, p in _flat(params).items()}


def init_decentralized_state(params_replicated: dict, optimizer: Optimizer,
                             sync: Optional[SyncConfig] = None) -> dict:
    """params_replicated: leading replica axis R on every leaf; the
    optimizer state's leaves (and its count) carry R too.

    Pass the step's `SyncConfig` to size the state for it: with a
    non-``none`` compression scheme the state grows a per-replica
    error-feedback `residuals` dict (zeros); with `overlap="one_step"`
    (and R > 1) the double-buffered `prev_grads` dict (zeros)."""
    params = params_replicated
    state = {"params": params, "opt": optimizer.init(params, stacked=True),
             "step": 0}
    if sync is not None and sync.compression.scheme != "none":
        state["residuals"] = init_residual(params)
    R = next(iter(params.values())).shape[0]
    if sync is not None and sync.overlap == "one_step" and R > 1:
        state["prev_grads"] = init_inflight(params)
    return state


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, {name: gradient}) of `loss_fn` at `params`, which are left
    as they are: the gradients flow to detached leaves sharing their
    storage."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with no_tf32(), torch.enable_grad():
        loss = loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    lr_fn: Callable, *, clip_norm: float = 1.0,
                    device="cuda") -> Callable:
    """step(state, batch) -> (state, metrics) on `device` (the card
    unless "cpu" is asked for); `batch` holds host arrays (tokens,
    labels) or tensors."""
    dev = resolve_device(device)

    def step(state, batch):
        loss, grads = _value_and_grad(cfg, state["params"], _on(batch, dev))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm, inplace=True)
            lr = lr_fn(state["step"])
            optimizer.update_(grads, state["opt"], state["params"], lr)
        del grads
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step


# ------------------------ decentralized (paper) ------------------------


def replica_grads(cfg: ModelConfig, params: dict, batch: dict):
    """(per-replica losses (R,), gradients stacked (R, ...)): replica r's
    loss on its row of `params` and of `batch` (R, per_replica, S), one
    forward and backward at a time."""
    R = next(iter(params.values())).shape[0]
    grads = {k: torch.empty_like(p) for k, p in params.items()}
    losses = []
    for r in range(R):
        loss, g = _value_and_grad(cfg, {k: p[r] for k, p in params.items()},
                                  {k: v[r] for k, v in batch.items()})
        for k, gk in g.items():
            grads[k][r].copy_(gk)
        del g
        losses.append(loss)
    return torch.stack(losses), grads


def clip_replicas_(grads: dict, clip_norm: float) -> torch.Tensor:
    """Clip R-stacked gradients in place to a global norm of
    ``clip_norm * sqrt(R)`` over all replicas (each replica's own budget
    of `clip_norm`, as the reference clips); returns the norm before."""
    R = next(iter(grads.values())).shape[0]
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm * R**0.5 / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return gnorm


def _pieces(leaf: torch.Tensor):
    """Column pieces of a (R, ...) leaf viewed as (R, D)."""
    flat = leaf.reshape(leaf.shape[0], -1)
    cols = max(1, _PIECE // leaf.shape[0])
    return flat.split(cols, dim=1)


def consensus_distance(params: dict) -> torch.Tensor:
    """RMS distance of replicas from their mean (leading axis R) — the
    training-side analogue of the paper's eps accuracy (0-d f32)."""
    sq, n = 0.0, 0
    for p in params.values():
        for piece in _pieces(p):
            pf = piece.float()
            d = pf - pf.mean(dim=0, keepdim=True)
            sq = sq + (d * d).sum()
        n += p.numel()
    return torch.sqrt(sq / max(n, 1))


def survivor_consensus_distance(params: dict,
                                live: torch.Tensor) -> torch.Tensor:
    """`consensus_distance` restricted to the live replicas of a faulty
    sync step: RMS distance of the live replicas from the *live* mean."""
    live_f = live.float()
    cnt = torch.clamp_min(live_f.sum(), 1.0)
    w = live_f[:, None]
    sq, n = 0.0, 0.0
    for p in params.values():
        for piece in _pieces(p):
            pf = piece.float()
            mean = (pf * w).sum(dim=0, keepdim=True) / cnt
            d = (pf - mean) * w
            sq = sq + (d * d).sum()
        n = n + cnt * (p.numel() // p.shape[0])
    return torch.sqrt(sq / torch.clamp_min(n, 1.0))


def make_decentralized_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    lr_fn: Callable,
    sync: SyncConfig,
    num_replicas: int,
    *,
    clip_norm: float = 1.0,
    mesh=None,
    device="cuda",
) -> Callable:
    """Step over replicated state on `device` (the card unless "cpu" is
    asked for): every leaf of params / opt carries a leading replica
    axis R; `batch` is (R, per_replica, S).

    The sync config is resolved to a static `SyncPlan` here, once.  With
    compression on, `state` must carry `residuals`, and with
    `overlap="one_step"` also `prev_grads`, from
    `init_decentralized_state(..., sync=sync)`.  `mesh` (the reference's
    shard_map executor) is not ported and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded sync executor (mesh=) is not ported yet (ROADMAP "
            "Queue A, several devices)")
    dev = resolve_device(device)
    R = num_replicas
    plan = build_sync_plan(sync, R)
    compressed = plan.compression.scheme != "none"
    overlapped = plan.overlapped

    def step(state, batch):
        if compressed and "residuals" not in state:
            raise ValueError(
                "compressed sync needs error-feedback state: build the train "
                "state with init_decentralized_state(params, opt, sync=sync)"
            )
        if overlapped and "prev_grads" not in state:
            raise ValueError(
                "overlap='one_step' needs the double-buffered in-flight "
                "gradients: build the train state with "
                "init_decentralized_state(params, opt, sync=sync)"
            )
        params, t = state["params"], state["step"]
        losses, grads = replica_grads(cfg, params, _on(batch, dev))
        with torch.no_grad():
            # per-replica clipping, then gossip mixing (the averaging)
            gnorm = clip_replicas_(grads, clip_norm)
            wire = plan_wire_bytes(plan, grads)
            if overlapped:
                # apply the PREVIOUS step's mixed gradients under the
                # rotation index and learning rate of the step that
                # produced them; the fresh ones go in flight
                mixed, residuals = execute_sync(
                    plan, state["prev_grads"], state.get("residuals"), t - 1,
                    inplace=True)
                state["prev_grads"] = grads
                warm = t > 0
                lr = lr_fn(max(t - 1, 0))
            else:
                mixed, residuals = execute_sync(
                    plan, grads, state.get("residuals"), t, inplace=True)
                warm = True
                lr = lr_fn(t)
            if warm:  # warm-up step 0 discards the update wholesale
                optimizer.update_(mixed, state["opt"], params, lr,
                                  stacked=True)
            del mixed, grads
            if "residuals" in state:
                state["residuals"] = residuals
            state["step"] = t + 1
            consensus = consensus_distance(params)
            # degradation metrics: the sync index's fault masks (the
            # executor drew the same ones), consensus over survivors only
            if plan.faulty:
                faults = replica_fault_masks(
                    plan.failures, R, t - 1 if overlapped else t, dev)
                surv_err = survivor_consensus_distance(params, faults.live)
                eff_frac = faults.live.float().mean()
                rejected = (faults.byzantine.float().sum()
                            if plan.robust_consensus else 0.0)
            else:
                surv_err, eff_frac, rejected = consensus, 1.0, 0.0
        metrics = {
            "loss": losses.mean(),
            "grad_norm": gnorm,
            "lr": lr,
            "consensus_distance": consensus,
            "wire_bytes": wire,
            # 1 on every overlapped step, 0 in warm-up and serialized mode
            "sync_overlap_fraction": float(overlapped and warm),
            "survivor_consensus_error": surv_err,
            "effective_replica_fraction": eff_frac,
            "rejected_gradient_count": rejected,
        }
        return state, metrics

    return step
