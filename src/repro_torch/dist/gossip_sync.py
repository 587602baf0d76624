"""Gradient synchronization strategies over a replica axis.

The paper's multiscale gossip (Algorithm 1), transplanted from wireless
sensor networks to decentralized data-parallel training: R parameter
replicas hold per-replica gradients (leading axis R on every leaf of a
dict of tensors) mixed according to a static `SyncPlan`
(`dist/plan.py`).  `execute_sync(plan, grads, residuals, step)` threads
compress -> fault injection -> rotate -> mix -> scatter-back, with
per-replica error-feedback residuals, through every strategy;
`sync_gradients` is the one-shot wrapper (no residual state across
calls).

Strategies
----------
``allreduce``
    Exact global mean, broadcast to every replica.
``hierarchical``
    Exact grouped fusion over the `levels` hierarchy: cell means at the
    finest scale, then means-of-means up to the root, broadcast back.
``ring``
    Flat gossip: `rounds` applications of the doubly-stochastic ring
    operator x <- (x + roll(x,+1) + roll(x,-1))/3 along the replica
    axis.  Preserves the replica mean; disagreement contracts by the
    ring's second eigenvalue per round.
``multiscale``
    Algorithm 1 on the replica set.  Bottom-up over the recursive cells
    from `suggest_levels`: ring mixing inside every cell of a level in
    parallel, then promotion of one representative per cell to the next
    coarser level; after the coarsest level mixes, every replica adopts
    its top-level cell's representative value.  ``exact_fusion=True``
    selects the mass-weighted variant (§VII), which with the uniform
    occupancy enforced here evaluates as the hierarchical ladder.

Every strategy, fault and aggregation acts on each coordinate of the
replica axis alone (means sum the replicas in one fixed order,
`robust.replica_mean`); compression needs one statistic of each
replica's row first (`compression.row_stats`).  So a leaf runs in
pieces of its columns, at most `_PIECE` elements each, and no more than
a piece's temporaries exist at a time (at R=8 and llama3.2-3b's
embedding a whole-leaf temporary would be 6.3 GB in bf16); the pieces
give the whole leaf's bits.  Leaves keep their dtype:
bf16 gradients mix in bf16, as in the reference.  With ``inplace=True``
the mixed values and the new residuals overwrite the tensors passed in.
"""
from __future__ import annotations

from typing import Optional

import torch

from .compression import init_residual, row_stats, sent
from .failures import fault_payload, replica_fault_masks
from .plan import STRATEGIES, SyncConfig, SyncPlan, build_sync_plan
from .robust import (
    replica_mean, resolve_trim, robust_reduce, survivor_weighted_fn,
)

__all__ = [
    "SyncConfig",
    "SyncPlan",
    "build_sync_plan",
    "execute_sync",
    "sync_gradients",
    "STRATEGIES",
]

_PIECE = 1 << 26  # elements (all R rows together) of one piece of a leaf


def execute_sync(
    plan: SyncPlan,
    grads: dict,
    residuals: Optional[dict] = None,
    step: int = 0,
    *,
    inplace: bool = False,
) -> tuple[dict, Optional[dict]]:
    """Run one synchronization under a static plan.

    grads: dict of tensors with leading replica axis `plan.R`.
    residuals: error-feedback state (same keys; zeros via
        `compression.init_residual` at step 0) when `plan.compression`
        is active; threaded through untouched otherwise.
    step: the sync index driving the rotation schedule and the faults.
    inplace: write the results into `grads` and `residuals` (which must
        be contiguous) instead of new tensors.

    Returns (mixed_grads, new_residuals).
    """
    R = plan.R
    for leaf in grads.values():
        if leaf.dim() < 1 or leaf.shape[0] != R:
            raise ValueError(
                f"every gradient leaf needs leading replica axis {R}, "
                f"got shape {tuple(leaf.shape)}"
            )
    if R == 1:
        return grads, residuals
    compressed = plan.compression.scheme != "none"
    if compressed and residuals is None:
        residuals = init_residual(grads)
    step = int(step)
    device = next(iter(grads.values())).device
    faults = (replica_fault_masks(plan.failures, R, step, device)
              if plan.faulty else None)
    return _sync_leaves(plan, grads, residuals, faults,
                        _mixer(plan, step, faults, device), inplace)


def _sync_leaves(plan, grads, residuals, faults, mix, inplace):
    """Every leaf through `_sync_leaf`: (mixed, new residuals)."""
    compressed = plan.compression.scheme != "none"
    mixed = grads if inplace else {}
    new_res = residuals if (inplace or not compressed) else {}
    for k, g in grads.items():
        out_g, out_r = _sync_leaf(plan, g, residuals[k] if compressed
                                  else None, faults, mix, inplace)
        mixed[k] = out_g
        if compressed:
            new_res[k] = out_r
    return mixed, new_res


def _sync_leaf(plan, g, r, faults, mix, inplace):
    """One leaf, piece by piece of its columns: (mixed, new residual).
    `g` holds the rows `faults` describes: all R, or one rank's row in
    the sharded executor, whose pieces have the same columns."""
    if inplace and not (g.is_contiguous()
                        and (r is None or r.is_contiguous())):
        raise ValueError("inplace sync needs contiguous leaves")
    R = g.shape[0]
    g2 = g.reshape(R, -1)
    r2 = r.reshape(R, -1) if r is not None else None
    out_g = g2 if inplace else torch.empty_like(g2)
    out_r = None
    if r is not None:
        out_r = r2 if inplace else torch.empty_like(r2)
        stats = row_stats(g2, r2, plan.compression)
    cols = max(1, _PIECE // plan.R)
    for a in range(0, g2.shape[1], cols):
        gc = g2[:, a:a + cols]
        acc = new_r = None
        if r is not None:
            acc = gc + r2[:, a:a + cols]
            payload = sent(acc, stats, plan.compression)
            new_r = acc - payload
        else:
            payload = gc
        if faults is not None:
            payload, new_r = fault_payload(
                payload, new_r, acc, faults.dropped, faults.byzantine,
                plan.failures.byzantine_scale)
        out_g[:, a:a + cols] = mix(payload)
        if new_r is not None:
            out_r[:, a:a + cols] = new_r
    return (out_g.view(g.shape),
            out_r.view(r.shape) if out_r is not None else None)


def _mixer(plan: SyncPlan, step: int, faults, device):
    """The map one piece (R, C) of the payload goes through."""
    R = plan.R
    if plan.robust_consensus:
        # Consensus-style robust reduction replaces the strategy's own
        # mixing (and is invariant to the rotation permutation).
        k_drop, k_trim = resolve_trim(plan.failures, R)
        dropped = (faults.dropped if faults is not None
                   else torch.zeros((R,), dtype=torch.bool, device=device))
        return lambda x: robust_reduce(plan.aggregation, x, dropped,
                                       k_drop, k_trim)
    if plan.strategy == "allreduce":
        fn = _allreduce
    elif plan.strategy == "hierarchical":
        fn = lambda g: _hierarchical(g, plan.levels)
    elif plan.strategy == "ring":
        fn = lambda g: _ring(g, plan.rounds[0])
    else:  # multiscale
        fn = lambda g: _multiscale(g, plan.levels, plan.rounds,
                                   plan.exact_fusion)
    if plan.rotated:
        fn = _rotate(fn, plan, step, device)
    if faults is None:
        return fn
    if plan.aggregation == "survivor_weighted":
        # weight-channel renormalization over live replicas, applied to
        # the (possibly rotation-conjugated) linear mixing operator
        fn = survivor_weighted_fn(fn, faults.live)
    live = faults.live[:, None]

    def masked(x, fn=fn):
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(live, fn(x), zero)
    return masked


def sync_gradients(grads: dict, cfg: SyncConfig, R: int) -> dict:
    """One-shot mix of a per-replica gradient dict (leading axis R):
    residuals start at zero and the new ones are dropped.  Exact
    strategies leave every replica holding the global mean; gossip
    strategies bound the replica disagreement by the mixing rounds."""
    mixed, _ = execute_sync(build_sync_plan(cfg, R), grads)
    return mixed


# ------------------------------ strategies ------------------------------


def _rotate(fn, plan: SyncPlan, step: int, device):
    """Conjugate a mixing operator by the step's rotation permutation:
    slot s of the mixed array holds replica perm[s]; the inverse
    scatters slot values back to their home replicas."""
    idx = step % len(plan.rotation)
    perm = torch.tensor(plan.rotation[idx], dtype=torch.int64, device=device)
    inv = torch.tensor(plan.rotation_inv[idx], dtype=torch.int64,
                       device=device)
    return lambda g: fn(g.index_select(0, perm)).index_select(0, inv)


def _allreduce(g: torch.Tensor) -> torch.Tensor:
    """Global mean over the replica axis, broadcast back to every replica."""
    return replica_mean(g).expand_as(g)


def _hierarchical(g: torch.Tensor, levels: tuple[int, ...]) -> torch.Tensor:
    """Grouped means finest-to-coarsest then broadcast back down."""
    shape = g.shape
    x = g.reshape(levels + shape[1:])
    for ax in range(len(levels) - 1, -1, -1):
        x = replica_mean(x, ax)
    return x.expand(levels + shape[1:]).reshape(shape)


def _ring_round(x: torch.Tensor) -> torch.Tensor:
    """One application of the doubly-stochastic ring operator on axis 0."""
    return (x + torch.roll(x, 1, dims=0) + torch.roll(x, -1, dims=0)) / 3.0


def _ring(g: torch.Tensor, rounds: int) -> torch.Tensor:
    """Flat neighbor gossip: `rounds` synchronized ring exchanges."""
    for _ in range(rounds):
        g = _ring_round(g)
    return g


def _mix_level(x: torch.Tensor, axis: int, rounds: int) -> torch.Tensor:
    """Ring-mix all cells of one level in parallel along `axis` (moved
    first and made contiguous once, so the rounds run on dense rows)."""
    if x.shape[axis] == 1:
        return x
    return _ring(x.movedim(axis, 0).contiguous(), rounds).movedim(0, axis)


def _multiscale(g: torch.Tensor, levels: tuple[int, ...],
                rounds: tuple[int, ...], exact_fusion: bool) -> torch.Tensor:
    """Algorithm 1 over the replica hierarchy.

    Axis layout after reshape: axis j hosts level-(j+1) cells; the last
    axis is the finest scale.  Bottom-up pass mixes within cells then
    promotes one representative per cell; top-level values disseminate
    back down by broadcast (the paper's n-message down-pass).
    """
    if exact_fusion:
        # with uniform occupancy (prod(levels) == R) the mass-weighted
        # fusion is identically the grouped-mean ladder
        return _hierarchical(g, levels)
    shape = g.shape
    x = g.reshape(levels + shape[1:])
    for ax in range(len(levels) - 1, 0, -1):
        x = _mix_level(x, ax, rounds[ax])
        # representative = cell member 0 after mixing (approx. cell mean)
        x = x.narrow(ax, 0, 1)
    # coarsest level: representatives gossip on the top ring
    x = _mix_level(x, 0, rounds[0])
    # down-pass: every replica adopts its top-level cell's value
    return x.expand(levels + shape[1:]).reshape(shape)
