"""Robust aggregation modes for decentralized gradient sync.

Plain gossip mixing averages whatever arrives; one Byzantine replica
transmitting ``-scale * g`` can therefore drag every honest replica's
mixed gradient arbitrarily far.  This module provides the aggregation
modes `SyncConfig.aggregation` selects from:

* ``"mean"`` — the strategy's own mixing untouched.
* ``"trimmed_mean"`` — per-coordinate sort over replicas, discard the
  ``k_trim`` smallest and largest live values, average the rest.  With
  ``k_trim >= #byzantine`` every surviving value is bracketed by honest
  values per coordinate, which is what bounds the aggregated norm.
* ``"coordinate_median"`` — per-coordinate median over live replicas
  (the maximally trimmed special case).
* ``"survivor_weighted"`` — keeps the plan's mixing strategy but runs
  it as a weight-channel pair ``fn(w * x) / fn(w)`` with ``w = live``:
  the doubly-stochastic mass that dropped replicas would have carried
  is renormalized over survivors instead of diluting the average with
  zeros.  All mixing strategies here are linear maps with row sums 1,
  so with no failures ``fn(w) == 1`` exactly and the division is a
  bitwise no-op.

`dist.failures` injects **exactly counted** fault sets, so the number
of dropped replicas and the trim width are static Python ints: the
masked statistics are fixed slices of one sort.  Dropped rows are
filled with ``-inf`` so the ascending sort parks them below every live
value; slicing then starts above them.

Trimmed mean and median are consensus operators (every live replica
gets the same aggregate), so they replace the strategy's mixing
entirely and are invariant to the rotation permutation; the executors
skip rotation for them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .failures import SyncFailureModel, fault_counts

__all__ = [
    "AGGREGATIONS",
    "masked_coordinate_median",
    "masked_trimmed_mean",
    "replica_mean",
    "resolve_trim",
    "robust_reduce",
    "survivor_weighted_fn",
    "tree_robust_reduce",
]

AGGREGATIONS = ("mean", "trimmed_mean", "coordinate_median",
                "survivor_weighted")


def resolve_trim(failures: Optional[SyncFailureModel],
                 R: int) -> tuple[int, int]:
    """Static (k_drop, k_trim) for the trimming aggregators.

    k_drop is the exact number of dropped (churned + straggler)
    replicas per step; k_trim defaults to the exact Byzantine count
    (the smallest width that provably brackets every corrupted value),
    or 1 when no model / no Byzantine replicas are declared but at
    least 3 live values remain.
    """
    if failures is None:
        kc = ks = kb = 0
    else:
        kc, ks, kb = fault_counts(failures, R)
    k_drop = kc + ks
    live = R - k_drop
    k_trim = kb if kb > 0 else (1 if live >= 3 else 0)
    return k_drop, k_trim


def replica_mean(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Mean over the replica axis `dim` (kept, size 1): the replicas
    summed one after another in f32 (bf16 upcast, as ``jnp.mean``
    does), divided, rounded to x's dtype.  Each coordinate's sum runs in
    the same order whatever the tensor's width or device, so a leaf
    mixed in pieces of columns, or on the card, gives the same bits."""
    acc = x.select(dim, 0).float()
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return (acc / x.shape[dim]).to(x.dtype).unsqueeze(dim)


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _sorted_live(x: torch.Tensor, dropped: torch.Tensor) -> torch.Tensor:
    """Sort replicas per coordinate with dropped rows parked at the
    bottom (they become -inf, which sorts below any live value)."""
    neg_inf = torch.full((), -torch.inf, dtype=x.dtype, device=x.device)
    return torch.sort(torch.where(_rows(dropped, x), neg_inf, x), dim=0).values


def masked_trimmed_mean(x: torch.Tensor, dropped: torch.Tensor,
                        k_drop: int, k_trim: int) -> torch.Tensor:
    """Per-coordinate mean of the live values with the k_trim smallest
    and largest discarded; returns the (1, ...) consensus row."""
    R = x.shape[0]
    if R - k_drop - 2 * k_trim < 1:
        raise ValueError(
            f"trimmed_mean needs at least one value after dropping "
            f"{k_drop} and trimming 2*{k_trim} of {R} replicas")
    s = _sorted_live(x, dropped)
    return replica_mean(s[k_drop + k_trim: R - k_trim])


def masked_coordinate_median(x: torch.Tensor, dropped: torch.Tensor,
                             k_drop: int) -> torch.Tensor:
    """Per-coordinate median over the live replicas; returns the
    (1, ...) consensus row."""
    R = x.shape[0]
    live = R - k_drop
    if live < 1:
        raise ValueError("coordinate_median needs at least one live replica")
    s = _sorted_live(x, dropped)
    lo = s[k_drop + (live - 1) // 2]
    hi = s[k_drop + live // 2]
    return ((lo + hi) / 2)[None]


def survivor_weighted_fn(
    fn: Callable[[torch.Tensor], torch.Tensor], live: torch.Tensor
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap a linear mixing map as its survivor-renormalized version.

    Values travel as ``(w * x, w)`` pairs with ``w = live``; the mixed
    value is ``fn(w * x) / fn(w)`` where the survivor mass ``fn(w)`` is
    clamped away from zero (a replica whose whole in-neighborhood
    dropped divides by ~0 mass and is masked to 0 by the caller).  `fn`
    acts on every coordinate alike, so the mass is taken on one column
    and broadcast.
    """
    def mixed(x: torch.Tensor) -> torch.Tensor:
        w = _rows(live.to(x.dtype), x)
        num = fn(w * x)
        den = fn(w)
        tiny = torch.finfo(x.dtype).tiny
        return num / torch.clamp_min(den, tiny)

    return mixed


def robust_reduce(aggregation: str, x: torch.Tensor, dropped: torch.Tensor,
                  k_drop: int, k_trim: int) -> torch.Tensor:
    """Dispatch the consensus-style aggregators on a dense (R, ...)
    leaf, broadcasting the consensus row back to every live replica
    (dropped replicas get zero — no update)."""
    if aggregation == "trimmed_mean":
        agg = masked_trimmed_mean(x, dropped, k_drop, k_trim)
    elif aggregation == "coordinate_median":
        agg = masked_coordinate_median(x, dropped, k_drop)
    else:
        raise ValueError(f"unknown robust reduce {aggregation!r}")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(_rows(dropped, x), zero, agg.expand_as(x))


def tree_robust_reduce(aggregation: str, tree: dict, dropped: torch.Tensor,
                       k_drop: int, k_trim: int) -> dict:
    return {k: robust_reduce(aggregation, x, dropped, k_drop, k_trim)
            for k, x in tree.items()}
