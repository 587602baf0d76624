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

With a replica `mesh` (a 1-dim `torch.distributed` `DeviceMesh`) the
decentralized step is SPMD: each of its R ranks holds one replica's rows
(leading axis 1, from `init_decentralized_state(..., mesh=)`) and its
block of the batch (`data.shard_batch`), and calls the step with the
same arguments.  The global clip norm sums each rank's f32 sum of
squares with an all-reduce, and the mix runs through
`dist.execute_sync_sharded`; both reassociate a sum, so a replica's
trajectory follows the dense step's to f32 rounding.

Both steps update the state IN PLACE (the reference's jit donates it)
and return it with the step's metrics: the llama3.2-3b state is tens of
GB, and a second copy would not fit beside it.

`make_train_step(..., dp=)` under a mesh (`launch.mesh.set_mesh`) is the
model-sharded step (`models.sharded`): the state holds this rank's
block of every parameter (`init_train_state` of the blocks, so the
optimizer's moments mirror them) and the batch its rows.  The gradients
come back as blocks of the global mean's; the clip norm sums each
block's f32 squares over every mesh dim the leaf is sharded on (and
none it is replicated on); the optimizer gets the mesh and the
parameters' specs (`sharding=`): AdamW and SGDM update the blocks as
they are, elementwise, and Adafactor sums its means over whole leaves
across the mesh dims that shard them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .._tf32 import no_tf32
from ..core.options import resolve_device
from ..data.pipeline import shard_slice
from ..dist import (
    SyncConfig, build_sync_plan, execute_sync, execute_sync_sharded,
    init_inflight, init_residual, plan_wire_bytes, replica_fault_masks,
)
from ..dist import collectives as C
from ..dist.async_sync import check_replica_mesh
from ..models import sharded
from ..models.config import ModelConfig
from ..models.model import DP_DEFAULT, loss_fn, param_dict, param_specs
from ..optim.optimizers import (
    Optimizer, clip_by_global_norm, global_norm, square_norm,
)

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
    those tensors and updates them in place).  On a mesh: this rank's
    blocks (`models.sharded.shard_params`); the moments mirror them."""
    params = _flat(params)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def replicate(params, R: int) -> dict:
    """R copies of the parameters stacked on a leading replica axis."""
    return {k: p.unsqueeze(0).expand((R,) + p.shape).clone()
            for k, p in _flat(params).items()}


def init_decentralized_state(params_replicated: dict, optimizer: Optimizer,
                             sync: Optional[SyncConfig] = None, *,
                             mesh=None, replica_axis: str = "replica") -> dict:
    """params_replicated: leading replica axis R on every leaf; the
    optimizer state's leaves (and its count) carry R too.

    Pass the step's `SyncConfig` to size the state for it: with a
    non-``none`` compression scheme the state grows a per-replica
    error-feedback `residuals` dict (zeros); with `overlap="one_step"`
    (and R > 1) the double-buffered `prev_grads` dict (zeros).

    With a replica `mesh` the state is this rank's rows of the dense
    one: its block of the R rows by `data.shard_slice`'s rule over
    `replica_axis` (copied, so the R rows can be freed)."""
    params = params_replicated
    R = next(iter(params.values())).shape[0]
    if mesh is not None:
        rows = shard_slice(R, mesh, replica_axis)
        params = {k: p[rows].clone() for k, p in params.items()}
    state = {"params": params, "opt": optimizer.init(params, stacked=True),
             "step": 0}
    if sync is not None and sync.compression.scheme != "none":
        state["residuals"] = init_residual(params)
    if sync is not None and sync.overlap == "one_step" and R > 1:
        state["prev_grads"] = init_inflight(params)
    return state


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict, dp=None):
    """(loss, {name: gradient}) of `loss_fn` at `params`, which are left
    as they are: the gradients flow to detached leaves sharing their
    storage.  `dp`: `loss_fn`'s (None: unsharded)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with no_tf32(), torch.enable_grad():
        loss = loss_fn(leaves, cfg, batch, dp=dp)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _sharded_norm(grads: dict, lay, specs: dict) -> torch.Tensor:
    """The global norm of sharded gradient blocks: each group of leaves
    sharded over the same mesh dims has its f32 sum of squares summed
    over those dims (a leaf replicated over a dim holds the same values
    on every rank there)."""
    groups: dict = {}
    for k, g in grads.items():
        groups.setdefault(sharded.sharded_dims(specs[k]), []).append(g)
    total = 0.0
    for dims in sorted(groups):
        sq = square_norm(groups[dims])
        total = total + (C.psum(sq, lay.mesh, dims) if dims else sq)
    return torch.sqrt(total)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    lr_fn: Callable, *, clip_norm: float = 1.0,
                    device="cuda", dp=DP_DEFAULT) -> Callable:
    """step(state, batch) -> (state, metrics) on `device` (the card
    unless "cpu" is asked for); `batch` holds host arrays (tokens,
    labels) or tensors.  Under a mesh with `dp`: the sharded step
    (module docstring) on this rank's blocks and rows; the metrics are
    global."""
    dev = resolve_device(device)

    def step(state, batch):
        lay = sharded.layout(cfg, dp)
        loss, grads = _value_and_grad(cfg, state["params"], _on(batch, dev),
                                      dp=dp)
        with torch.no_grad():
            specs = None if lay is None else param_specs(cfg, lay.mesh)
            norm = None if lay is None else _sharded_norm(grads, lay, specs)
            grads, gnorm = clip_by_global_norm(grads, clip_norm, inplace=True,
                                               norm=norm)
            lr = lr_fn(state["step"])
            optimizer.update_(grads, state["opt"], state["params"], lr,
                              sharding=None if lay is None
                              else (lay.mesh, specs))
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


def clip_replicas_(grads: dict, clip_norm: float, *, mesh=None,
                   replica_axis: str = "replica") -> torch.Tensor:
    """Clip R-stacked gradients in place to a global norm of
    ``clip_norm * sqrt(R)`` over all replicas (each replica's own budget
    of `clip_norm`, as the reference clips); returns the norm before.
    With a replica `mesh` `grads` holds this rank's rows, and the f32
    sums of squares of all R replicas are all-reduced."""
    if mesh is None:
        R = next(iter(grads.values())).shape[0]
        gnorm = global_norm(grads)
    else:
        R = C.axis_size(mesh, replica_axis)
        gnorm = torch.sqrt(C.psum(square_norm(grads), mesh, replica_axis))
    scale = torch.clamp(clip_norm * R**0.5 / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return gnorm


def _pieces(leaf: torch.Tensor, R: int):
    """Column pieces of a (rows, ...) leaf viewed as (rows, D), as wide
    as R rows allow."""
    flat = leaf.reshape(leaf.shape[0], -1)
    return flat.split(max(1, _PIECE // R), dim=1)


def consensus_distance(params: dict, *, mesh=None,
                       replica_axis: str = "replica") -> torch.Tensor:
    """RMS distance of replicas from their mean (leading axis R) — the
    training-side analogue of the paper's eps accuracy (0-d f32).  With
    a replica `mesh` `params` holds this rank's rows; the mean and the
    sum are all-reduced."""
    R = (next(iter(params.values())).shape[0] if mesh is None
         else C.axis_size(mesh, replica_axis))
    sq, n = 0.0, 0
    for p in params.values():
        for piece in _pieces(p, R):
            pf = piece.float()
            mean = (pf.mean(dim=0, keepdim=True) if mesh is None
                    else C.pmean(pf, mesh, replica_axis))
            d = pf - mean
            sq = sq + (d * d).sum()
        n += p.numel()
    if mesh is not None:
        sq, n = C.psum(sq, mesh, replica_axis), n * R
    return torch.sqrt(sq / max(n, 1))


def survivor_consensus_distance(params: dict, live: torch.Tensor, *,
                                mesh=None,
                                replica_axis: str = "replica") -> torch.Tensor:
    """`consensus_distance` restricted to the live replicas of a faulty
    sync step: RMS distance of the live replicas from the *live* mean.
    `live` is the (R,) mask; with a replica `mesh` `params` holds this
    rank's rows, and the sums are all-reduced."""
    live_f = live.float()
    cnt = torch.clamp_min(live_f.sum(), 1.0)
    R = live.shape[0]
    if mesh is not None:
        rows = shard_slice(R, mesh, replica_axis)
        live_f = live_f[rows]
    w = live_f[:, None]
    sq, n = 0.0, 0.0
    for p in params.values():
        for piece in _pieces(p, R):
            pf = piece.float()
            total = (pf * w).sum(dim=0, keepdim=True)
            if mesh is not None:
                total = C.psum(total, mesh, replica_axis)
            d = (pf - total / cnt) * w
            sq = sq + (d * d).sum()
        n = n + cnt * (p.numel() // p.shape[0])
    if mesh is not None:
        sq = C.psum(sq, mesh, replica_axis)
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
    replica_axis: str = "replica",
    device="cuda",
) -> Callable:
    """Step over replicated state on `device` (the card unless "cpu" is
    asked for): every leaf of params / opt carries a leading replica
    axis R; `batch` is (R, per_replica, S).

    The sync config is resolved to a static `SyncPlan` here, once.  With
    compression on, `state` must carry `residuals`, and with
    `overlap="one_step"` also `prev_grads`, from
    `init_decentralized_state(..., sync=sync)`.  A replica `mesh` (a
    1-dim `DeviceMesh` whose `replica_axis` dim has R ranks) makes the
    step SPMD (module docstring): the state holds this rank's rows, the
    batch is its block (1, per_replica, S), the mix runs through
    `dist.execute_sync_sharded`, and the metrics are the replicas'
    (``"replica_loss"`` is this rank's own loss).
    """
    dev = resolve_device(device)
    R = num_replicas
    plan = build_sync_plan(sync, R)
    if mesh is not None:
        check_replica_mesh(plan, mesh, replica_axis)
    compressed = plan.compression.scheme != "none"
    overlapped = plan.overlapped
    on_mesh = dict(mesh=mesh, replica_axis=replica_axis)

    def mix(grads, residuals, s):
        if mesh is None:
            return execute_sync(plan, grads, residuals, s, inplace=True)
        return execute_sync_sharded(plan, grads, residuals, s, mesh=mesh,
                                    axis_name=replica_axis, inplace=True)

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
            gnorm = clip_replicas_(grads, clip_norm, **on_mesh)
            wire = plan_wire_bytes(plan, grads)
            if overlapped:
                # apply the PREVIOUS step's mixed gradients under the
                # rotation index and learning rate of the step that
                # produced them; the fresh ones go in flight
                mixed, residuals = mix(state["prev_grads"],
                                       state.get("residuals"), t - 1)
                state["prev_grads"] = grads
                warm = t > 0
                lr = lr_fn(max(t - 1, 0))
            else:
                mixed, residuals = mix(grads, state.get("residuals"), t)
                warm = True
                lr = lr_fn(t)
            if warm:  # warm-up step 0 discards the update wholesale
                optimizer.update_(mixed, state["opt"], params, lr,
                                  stacked=True)
            del mixed, grads
            if "residuals" in state:
                state["residuals"] = residuals
            state["step"] = t + 1
            consensus = consensus_distance(params, **on_mesh)
            # degradation metrics: the sync index's fault masks (the
            # executor drew the same ones), consensus over survivors only
            if plan.faulty:
                faults = replica_fault_masks(
                    plan.failures, R, t - 1 if overlapped else t, dev)
                surv_err = survivor_consensus_distance(params, faults.live,
                                                       **on_mesh)
                eff_frac = faults.live.float().mean()
                rejected = (faults.byzantine.float().sum()
                            if plan.robust_consensus else 0.0)
            else:
                surv_err, eff_frac, rejected = consensus, 1.0, 0.0
            loss = (losses.mean() if mesh is None else
                    C.psum(losses.sum(), mesh, replica_axis) / R)
        metrics = {
            "loss": loss,
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
        if mesh is not None:
            metrics["replica_loss"] = losses[0]
        return state, metrics

    return step
