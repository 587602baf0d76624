"""Asynchronous (overlapped) gradient synchronization, and the sharded
sync executor.

The paper's analysis rests on an asynchronous time model: nodes gossip
without a global clock.  The training-stack transplant of that idea is
**one-step-delayed gradient averaging** (`SyncConfig(overlap=
"one_step")`): step `t` applies the *previous* step's mixed gradients
while step `t`'s fresh gradients become the in-flight buffer, so the mix
has no data dependency on the current backward pass.  The train state
carries a double-buffered `prev_grads` dict; the error-feedback residual
rides along exactly as in the serialized path, one step late.

Staleness correction: the delayed gradients are mixed under the
rotation index (and applied under the learning rate) of the step that
*produced* them (`step - 1`), so the overlapped trajectory is the
serialized one delayed by exactly one step on a step-independent
gradient stream.  Warmup: at step 0 the buffer holds zeros and the
train step discards the update.

Two executors:

`async_execute_sync(plan, grads, prev_grads, residuals, step)`
    The functional pipeline stage: mixes `prev_grads` (rotation index
    `step - 1`), returns the mixed result, the new in-flight buffer
    (= `grads`), and the updated residuals.  With `mesh=` the mix runs
    through `execute_sync_sharded`.

`execute_sync_sharded(plan, grads, residuals, step, mesh=...)`
    The same mixing semantics as explicit per-replica collectives on a
    `torch.distributed` process mesh (`dist.collectives`): each rank
    holds one replica's row and calls it with the same arguments.  The
    replica dim is laid out over a mesh shaped like `plan.levels`; ring
    gossip within a cell is `ppermute` along one level's dim, grouped
    fusion is `pmean` along one dim, and dissemination is a broadcast
    from index 0.  Where no mean enters (ring, plain multiscale, the
    trimmed mean and the median, with rotation, faults and error
    feedback) each row is bitwise the dense executor's; a `pmean`
    reassociates its sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives as C
from .compression import init_residual
from .failures import ReplicaFaults, replica_fault_masks
from .gossip_sync import _sync_leaves, execute_sync
from .plan import SyncPlan
from .robust import (
    masked_coordinate_median, masked_trimmed_mean, resolve_trim,
    survivor_weighted_fn,
)

__all__ = [
    "async_execute_sync", "check_replica_mesh", "execute_sync_sharded",
    "init_inflight",
]


def init_inflight(grads_like: dict) -> dict:
    """Zero in-flight gradient buffer (the second half of the double
    buffer) matching the gradient dict."""
    return {k: torch.zeros_like(g) for k, g in grads_like.items()}


def async_execute_sync(
    plan: SyncPlan,
    grads: dict,
    prev_grads: dict,
    residuals: Optional[dict] = None,
    step: int = 0,
    *,
    mesh=None,
    axis_name: str = "replica",
    inplace: bool = False,
) -> tuple[dict, dict, Optional[dict]]:
    """One stage of the overlapped sync pipeline.

    grads: the current step's fresh (clipped) gradients — NOT mixed yet;
        they become the new in-flight buffer.
    prev_grads: the previous step's gradients (zeros at step 0).
    residuals / step: threaded to `execute_sync`; the rotation schedule
        and the faults are indexed at `step - 1`, the sync index of the
        step that produced `prev_grads`.
    mesh: a replica `DeviceMesh`: the mix runs through
        `execute_sync_sharded` over its `axis_name` dim, and every dict
        holds this rank's row.
    inplace: mix into `prev_grads` (and `residuals`) in place.

    Returns (applied, new_prev_grads, new_residuals) where `applied` is
    `mix(prev_grads)` and `new_prev_grads` is `grads`.
    """
    if mesh is not None:
        applied, new_residuals = execute_sync_sharded(
            plan, prev_grads, residuals, int(step) - 1, mesh=mesh,
            axis_name=axis_name, inplace=inplace)
    else:
        applied, new_residuals = execute_sync(
            plan, prev_grads, residuals, int(step) - 1, inplace=inplace)
    return applied, grads, new_residuals


# ------------------------- the sharded executor -------------------------
#
# Dim layout: the replica dim is reshaped over a mesh of shape
# `plan.levels` (one named dim a hierarchy level, coarsest first), so
# level-l cells are exactly the ranks sharing every coordinate but dim
# l.  Flat strategies (allreduce / ring) use a single dim.

_DIM_FMT = "gossip{}"
_LEVEL_MESHES: dict = {}


def check_replica_mesh(plan: SyncPlan, mesh, axis_name: str) -> None:
    """Raise ValueError unless `mesh` is a 1-dim mesh whose `axis_name`
    dim has `plan.R` ranks."""
    names = tuple(mesh.mesh_dim_names or ())
    shape = dict(zip(names, mesh.shape))
    if axis_name not in names:
        raise ValueError(
            f"mesh {shape} has no dim {axis_name!r} to shard replicas over")
    if shape[axis_name] != plan.R:
        raise ValueError(
            f"mesh dim {axis_name!r} has {shape[axis_name]} ranks but the "
            f"plan serves R={plan.R} replicas")
    if len(names) != 1:
        raise ValueError(
            f"execute_sync_sharded wants a dedicated 1-dim replica mesh, "
            f"got {shape}")


def _level_mesh(plan: SyncPlan, mesh, axis_name: str):
    """The caller's replica dim reshaped into one mesh dim a level:
    (level mesh, its dim names).  Building a `DeviceMesh` makes process
    groups, a collective call, so every rank builds each (mesh, shape)
    once, in the same order, and keeps it."""
    check_replica_mesh(plan, mesh, axis_name)
    levels = (plan.levels if plan.strategy in ("hierarchical", "multiscale")
              else (plan.R,))
    dims = tuple(_DIM_FMT.format(i) for i in range(len(levels)))
    key = (mesh, levels)
    if key not in _LEVEL_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _LEVEL_MESHES[key] = DeviceMesh(
            mesh.device_type, mesh.mesh.reshape(levels), mesh_dim_names=dims)
    return _LEVEL_MESHES[key], dims


def _ring_pairs(L: int, shift: int) -> list[tuple[int, int]]:
    """(src, dst) pairs of a ring shift along one dim: dst i reads
    i + shift."""
    return [((i + shift) % L, i) for i in range(L)]


def _shard_ring_round(x, lm, dim: str, L: int):
    """One doubly-stochastic ring round along a mesh dim, added in the
    dense `_ring_round`'s order (x + x[i-1] + x[i+1]), so bitwise; the
    two shifts travel in one batch."""
    dn, up = C.ppermutes(x, lm, dim,
                         [_ring_pairs(L, -1), _ring_pairs(L, 1)])
    return (x + dn + up) / 3.0


def _shard_mix_axis(x, lm, dim: str, L: int, rounds: int):
    if L == 1:
        return x
    for _ in range(rounds):
        x = _shard_ring_round(x, lm, dim, L)
    return x


def _shard_strategy(plan: SyncPlan, lm, dims: tuple[str, ...]):
    """Per-rank mixing of one piece (local shape (1, cols))."""
    levels = plan.levels

    if plan.strategy == "allreduce":
        return lambda x: C.pmean(x, lm, dims)

    if plan.strategy == "hierarchical" or (
            plan.strategy == "multiscale" and plan.exact_fusion):
        # the grouped-mean ladder: cell means at the finest scale, then
        # means of means up (uniform occupancy makes each coarser pmean
        # the fusion of that level's cell means)
        def ladder(x):
            for dim in reversed(dims):
                x = C.pmean(x, lm, dim)
            return x
        return ladder

    if plan.strategy == "ring":
        return lambda x: _shard_mix_axis(x, lm, dims[0], plan.R,
                                         plan.rounds[0])

    # plain multiscale (Algorithm 1): per-cell ring gossip bottom-up;
    # ranks whose finer coordinates are nonzero compute dead values past
    # their own level, which the down-pass overwrites from the
    # representative (index 0) plane, coarse to fine
    def multiscale(x):
        for ax in range(len(levels) - 1, -1, -1):
            x = _shard_mix_axis(x, lm, dims[ax], levels[ax], plan.rounds[ax])
        for dim in dims[1:]:
            x = C.bcast_from_zero(x, lm, dim)
        return x
    return multiscale


def _shard_rotate(fn, plan: SyncPlan, lm, dims, step: int):
    """Rotation conjugation in collective form: slot s reads replica
    perm[s] (pairs perm[s] -> s), mixes, and the scatter-back inverts
    the pairs; the step picks the permutation on the host."""
    perm = plan.rotation[step % len(plan.rotation)]
    fwd = [(int(perm[s]), s) for s in range(plan.R)]
    bwd = [(s, int(perm[s])) for s in range(plan.R)]
    return lambda x: C.ppermute(fn(C.ppermute(x, lm, dims, fwd)), lm, dims,
                                bwd)


def _shard_mixer(plan: SyncPlan, lm, dims, step: int,
                 faults: Optional[ReplicaFaults], rid: int, device):
    """The map one piece (1, cols) of this rank's payload goes through."""
    if plan.robust_consensus:
        # gather the whole replica dim (row-major over the level dims is
        # the dense replica order) and reduce it: a consensus value,
        # the same on every rank, zero on a dropped one
        k_drop, k_trim = resolve_trim(plan.failures, plan.R)
        dropped = (faults.dropped if faults is not None
                   else torch.zeros((plan.R,), dtype=torch.bool,
                                    device=device))

        def robust(x):
            full = C.all_gather(x, lm, dims)
            if plan.aggregation == "trimmed_mean":
                agg = masked_trimmed_mean(full, dropped, k_drop, k_trim)
            else:
                agg = masked_coordinate_median(full, dropped, k_drop)
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            return torch.where(dropped[rid], zero, agg)
        return robust
    fn = _shard_strategy(plan, lm, dims)
    if plan.rotated:
        fn = _shard_rotate(fn, plan, lm, dims, step)
    if faults is None:
        return fn
    live = faults.live[rid:rid + 1]
    if plan.aggregation == "survivor_weighted":
        fn = survivor_weighted_fn(fn, live)

    def masked(x, fn=fn):
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(live[:, None], fn(x), zero)
    return masked


def execute_sync_sharded(
    plan: SyncPlan,
    grads: dict,
    residuals: Optional[dict] = None,
    step: int = 0,
    *,
    mesh,
    axis_name: str = "replica",
    inplace: bool = False,
) -> tuple[dict, Optional[dict]]:
    """`execute_sync` as explicit collectives over a replica mesh.

    mesh: a 1-dim `DeviceMesh` whose `axis_name` dim has `plan.R`
        ranks; every rank calls this with its own replica's row.
    grads: this rank's row, every leaf (1, *payload); residuals alike.
        Each rank compresses its own row and recomputes the step's fault
        masks, indexed at its replica id (its mesh coordinate).
    step: the sync index driving the rotation schedule and the faults.
    inplace: write the results into `grads` and `residuals`.

    Returns this rank's (mixed_grads, new_residuals).
    """
    if plan.R == 1:
        return grads, residuals
    lm, dims = _level_mesh(plan, mesh, axis_name)
    for leaf in grads.values():
        if leaf.dim() < 1 or leaf.shape[0] != 1:
            raise ValueError(
                f"every gradient leaf needs leading axis 1 (this rank's "
                f"replica), got shape {tuple(leaf.shape)}")
    if plan.compression.scheme != "none" and residuals is None:
        residuals = init_residual(grads)
    step = int(step)
    device = next(iter(grads.values())).device
    rid = C.axis_index(lm, dims)
    faults = (replica_fault_masks(plan.failures, plan.R, step, device)
              if plan.faulty else None)
    mix = _shard_mixer(plan, lm, dims, step, faults, rid, device)
    row = (ReplicaFaults(*(m[rid:rid + 1] for m in faults))
           if faults is not None else None)
    return _sync_leaves(plan, grads, residuals, row, mix, inplace)
