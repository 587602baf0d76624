"""Replica-failure injection for decentralized gradient sync.

The training-stack twin of `core.medium.FailureModel`: the paper prices
multiscale gossip on an unreliable wireless medium where packets drop
mid-exchange; in decentralized training the analogous event is a
*replica* that disappears mid-sync — preempted, partitioned, or slow
enough to miss the round — or one that ships a corrupted gradient.
`SyncFailureModel` is the static, hashable description of that surface;
it rides `SyncConfig` → `SyncPlan` like every other sync knob.

Per-step fault sets are drawn deterministically from ``(seed, step)``
with **exact disjoint counts** (one permutation per step, sliced into
churned / straggler / Byzantine ranks).  The permutation is
``jax.random.permutation`` bit for bit (`core.prng.permutation`, in the
older threefry layout the port keeps), so the port injects the
reference's faults at every step; the exact counts keep the robust
aggregators' trims static.

Semantics per sync step:

* **churned / straggler replicas** are absent: their payload does not
  travel and they receive nothing (their mixed gradient is zero — the
  step applies no update to them).  With error-feedback compression on,
  a dropped replica's whole accumulator ``grads + residual`` stays in
  its residual — bitwise, nothing is lost — and re-enters the mix when
  it rejoins.
* **Byzantine replicas** stay in the round but transmit an adversarial
  payload (sign-flipped and scaled by ``byzantine_scale``); defending
  against it is the job of the robust aggregation modes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core import prng

__all__ = [
    "ReplicaFaults",
    "SyncFailureModel",
    "apply_payload_faults",
    "fault_counts",
    "replica_fault_masks",
]


@dataclasses.dataclass(frozen=True)
class SyncFailureModel:
    """Static (hashable) per-step replica fault injection.

    churn_fraction: fraction of replicas absent from each sync step
        (gone: no payload sent, none received).
    straggler_fraction: fraction of replicas that miss the sync round
        (late: same per-step effect as churn, named separately for
        scenario matrices).
    byzantine_fraction: fraction of replicas transmitting an
        adversarial payload (sign-flipped, scaled).
    byzantine_scale: magnitude of the corruption; the transmitted
        payload is ``-byzantine_scale * honest_payload``.
    seed: fault-injection RNG seed — per-step sets are deterministic in
        ``(seed, step)`` and independent of the gossip/rotation seeds.

    The three sets are disjoint by construction and exactly sized
    (``round(fraction * R)`` replicas each).  `build_sync_plan`
    validates that at least one honest replica survives.
    """

    churn_fraction: float = 0.0
    straggler_fraction: float = 0.0
    byzantine_fraction: float = 0.0
    byzantine_scale: float = 10.0
    seed: int = 0

    def __post_init__(self):
        for name in ("churn_fraction", "straggler_fraction",
                     "byzantine_fraction"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.byzantine_scale < 0:
            raise ValueError(
                f"byzantine_scale must be >= 0, got {self.byzantine_scale}")

    @property
    def active(self) -> bool:
        """True when any fault family injects at least a nonzero rate."""
        return (
            self.churn_fraction > 0
            or self.straggler_fraction > 0
            or self.byzantine_fraction > 0
        )


class ReplicaFaults(NamedTuple):
    """Per-step (R,) boolean fault masks; `dropped` = churned|straggler,
    `live` is its complement (Byzantine replicas are live)."""

    churned: torch.Tensor
    straggler: torch.Tensor
    byzantine: torch.Tensor
    dropped: torch.Tensor
    live: torch.Tensor


def fault_counts(model: SyncFailureModel, R: int) -> tuple[int, int, int]:
    """Static (k_churn, k_straggler, k_byzantine) set sizes for R
    replicas — `round(fraction * R)` each."""
    return (
        int(round(model.churn_fraction * R)),
        int(round(model.straggler_fraction * R)),
        int(round(model.byzantine_fraction * R)),
    )


def replica_fault_masks(model: SyncFailureModel, R: int, step: int,
                        device=None) -> ReplicaFaults:
    """Draw the step's fault sets on `device` (the CPU unless given),
    deterministic in ``(model.seed, step)``.

    One replica permutation is drawn per step; ranks ``[0, kc)`` churn,
    ``[kc, kc+ks)`` straggle, ``[kc+ks, kc+ks+kb)`` turn Byzantine.
    `step` is taken as an int32, as the reference folds it in.
    """
    kc, ks, kb = fault_counts(model, R)
    key = prng.fold_in(prng.PRNGKey(model.seed, device=device),
                       _int32(step))
    perm = prng.permutation(key, R)
    # rank[i] = position of replica i in the permutation
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(R, dtype=perm.dtype, device=perm.device)
    churned = rank < kc
    straggler = (rank >= kc) & (rank < kc + ks)
    byzantine = (rank >= kc + ks) & (rank < kc + ks + kb)
    dropped = churned | straggler
    return ReplicaFaults(
        churned=churned, straggler=straggler, byzantine=byzantine,
        dropped=dropped, live=~dropped,
    )


def _int32(step: int) -> int:
    """`step` wrapped to int32, as ``jnp.asarray(step, jnp.int32)``."""
    return (int(step) + 2**31) % 2**32 - 2**31


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A replica mask with singleton axes to broadcast over a leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.dim() - mask.dim()))


def fault_payload(payload: torch.Tensor, new_residual: Optional[torch.Tensor],
                  acc: Optional[torch.Tensor], dropped: torch.Tensor,
                  byzantine: torch.Tensor, byzantine_scale: float):
    """One leaf (or piece of its columns) of `apply_payload_faults`:
    dropped rows send zeros and, when residuals are carried, keep the
    whole accumulator `acc` = grads + residuals as their residual;
    Byzantine rows send ``-byzantine_scale`` times their payload."""
    zero = torch.zeros((), dtype=payload.dtype, device=payload.device)
    payload = torch.where(_bcast(dropped, payload), zero, payload)
    if new_residual is not None:
        new_residual = torch.where(_bcast(dropped, new_residual), acc,
                                   new_residual)
    scale = torch.tensor(-float(byzantine_scale), dtype=torch.float32,
                         device=payload.device).to(payload.dtype)
    payload = torch.where(_bcast(byzantine, payload), scale * payload,
                          payload)
    return payload, new_residual


def apply_payload_faults(
    payload: dict,
    new_residuals: Optional[dict],
    grads: Optional[dict],
    residuals: Optional[dict],
    dropped: torch.Tensor,
    byzantine: torch.Tensor,
    byzantine_scale: float,
) -> tuple[dict, Optional[dict]]:
    """Inject the step's faults into the as-transmitted payload.

    Dropped replicas transmit nothing: their payload rows become zero
    and — when error-feedback residuals are carried — their residual
    becomes the full accumulator ``grads + residuals``, so ``payload +
    residual == grads + residuals`` holds BITWISE for dropped rows as
    `compression.compress` guarantees it for live ones.  Byzantine
    replicas then overwrite their (live) rows with the sign-flipped
    scaled payload; their own residual bookkeeping is left untouched.
    """
    out_p, out_r = {}, ({} if new_residuals is not None else None)
    for k, p in payload.items():
        nr = acc = None
        if new_residuals is not None:
            nr, acc = new_residuals[k], grads[k] + residuals[k]
        out_p[k], r = fault_payload(p, nr, acc, dropped, byzantine,
                                    byzantine_scale)
        if out_r is not None:
            out_r[k] = r
    return out_p, out_r
