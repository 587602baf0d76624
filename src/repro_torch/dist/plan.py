"""SyncPlan — ahead-of-time planning for decentralized gradient sync.

Mirror of the simulation core's plan/execute split (`core/plan.py` /
`core/engine.py`) on the training stack: everything about a
synchronization strategy that does not depend on gradient *values* is
resolved once, host-side, into a static hashable `SyncPlan` —

* the replica hierarchy (branching factors from `suggest_levels`, or
  the user's `levels`) and per-level mixing rounds,
* the step-indexed **cell-rotation schedule** (the paper's randomized
  cells §IV transplanted to replicas: a precomputed table of replica
  permutations cycled by step, so a slow straggler is not pinned to
  one cell and its neighbors change every sync),
* the `CompressionConfig` for error-feedback compressed payloads,
* the wire-byte accounting model used by metrics.

`build_sync_plan(cfg, R)` validates the whole configuration with clear
errors at construction time; the plan is then consumed by
`gossip_sync.execute_sync(plan, grads, residuals, step)` — one plan
serves every step of a training run.  Pure Python and numpy: the
reference's module, with the payload bytes read off tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .compression import CompressionConfig, wire_fraction
from .failures import SyncFailureModel, fault_counts
from .robust import AGGREGATIONS, resolve_trim
from .topology import default_rounds, rotation_schedule, suggest_levels

__all__ = [
    "AGGREGATIONS",
    "OVERLAP_MODES",
    "SyncConfig",
    "SyncPlan",
    "build_sync_plan",
    "plan_wire_bytes",
    "tree_payload_bytes",
]

STRATEGIES = ("allreduce", "hierarchical", "ring", "multiscale")
_GOSSIP = ("ring", "multiscale")  # strategies whose topology can rotate
OVERLAP_MODES = ("none", "one_step")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Static (hashable) description of one synchronization strategy.

    levels: branching factors coarsest-first, product == R; () defers to
        `suggest_levels(R)` at plan time (ignored by allreduce/ring).
    rounds: per-level mixing rounds.  For `ring` a single entry is the
        number of global ring rounds; for `multiscale` either one entry
        shared by all levels or one per level; () picks
        `default_rounds(cell_size)` per level.
    exact_fusion: multiscale only — mass-weighted exact fusion that
        preserves the replica mean bitwise at every scale.
    compression: error-feedback payload compression (a
        `CompressionConfig`, or its scheme name as a string).
    rotation_period: > 0 enables the randomized-cell schedule on gossip
        strategies: a table of `rotation_period` replica permutations is
        drawn from `rotation_seed` and cycled by sync step.  0 (default)
        keeps the static assignment — exact strategies are unaffected
        either way.
    overlap: "none" (default) runs sync strictly after the backward
        pass; "one_step" selects one-step-delayed averaging (the paper's
        asynchronous time model applied to step pipelining): each step
        applies the PREVIOUS step's mixed gradients while the current
        step's gossip has no data dependency on the backward and can
        execute concurrently.  The train state then carries a
        double-buffered `prev_grads` pytree (see `dist.async_sync`).
    failures: optional `SyncFailureModel` injecting per-step replica
        churn, stragglers, and Byzantine payloads into every executor
        (see `dist.failures`).  None (default) is the reliable path,
        bitwise-identical to a plan without the field.
    aggregation: how per-replica payloads are combined under (possible)
        faults — one of `dist.robust.AGGREGATIONS`.  "mean" (default)
        is the strategy's own mixing; "trimmed_mean" /
        "coordinate_median" are per-coordinate robust consensus
        reductions (Byzantine defense); "survivor_weighted" keeps the
        strategy but renormalizes doubly-stochastic mass over live
        replicas (churn defense).
    """

    strategy: str = "allreduce"
    levels: tuple[int, ...] = ()
    rounds: tuple[int, ...] = ()
    exact_fusion: bool = False
    compression: CompressionConfig = CompressionConfig()
    rotation_period: int = 0
    rotation_seed: int = 0
    overlap: str = "none"
    failures: Optional[SyncFailureModel] = None
    aggregation: str = "mean"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; expected one of {STRATEGIES}"
            )
        object.__setattr__(self, "levels", tuple(int(l) for l in self.levels))
        object.__setattr__(self, "rounds", tuple(int(r) for r in self.rounds))
        if isinstance(self.compression, str):
            object.__setattr__(
                self, "compression", CompressionConfig(self.compression)
            )
        if any(l < 1 for l in self.levels):
            raise ValueError(f"levels must be positive, got {self.levels}")
        if any(r < 0 for r in self.rounds):
            raise ValueError(f"rounds must be >= 0, got {self.rounds}")
        if self.strategy == "ring" and len(self.rounds) > 1:
            raise ValueError(
                f"ring takes a single global round count, got rounds={self.rounds}"
            )
        if (
            self.levels
            and len(self.rounds) > 1
            and len(self.rounds) != len(self.levels)
        ):
            raise ValueError(
                f"rounds {self.rounds} has {len(self.rounds)} entries but levels "
                f"{self.levels} has {len(self.levels)}; pass one round count per "
                f"level, a single shared entry, or () for defaults"
            )
        if self.rotation_period < 0:
            raise ValueError(
                f"rotation_period must be >= 0, got {self.rotation_period}"
            )
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(
                f"unknown overlap mode {self.overlap!r}; expected one of "
                f"{OVERLAP_MODES}"
            )
        if self.failures is not None and not isinstance(
            self.failures, SyncFailureModel
        ):
            raise ValueError(
                f"failures must be a SyncFailureModel or None, "
                f"got {self.failures!r}"
            )
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(
                f"unknown aggregation {self.aggregation!r}; expected one of "
                f"{AGGREGATIONS}"
            )

    def resolved_levels(self, R: int) -> tuple[int, ...]:
        levels = self.levels or suggest_levels(R)
        prod = 1
        for l in levels:
            prod *= l
        if prod != R:
            raise ValueError(
                f"levels {levels} factor {prod} replicas but R={R}; levels must "
                f"multiply out to the replica count exactly"
            )
        return levels

    def resolved_rounds(self, levels: tuple[int, ...]) -> tuple[int, ...]:
        if not self.rounds:
            return tuple(default_rounds(l) for l in levels)
        if len(self.rounds) == 1:
            return self.rounds * len(levels)
        if len(self.rounds) != len(levels):
            # reachable when levels were deferred to suggest_levels(R);
            # explicit levels fail the same check in __post_init__
            raise ValueError(
                f"rounds {self.rounds} has {len(self.rounds)} entries but "
                f"levels {levels} has {len(levels)}; pass one round count per "
                f"level, a single shared entry, or () for defaults"
            )
        return self.rounds


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """Fully resolved, hashable synchronization plan for R replicas.

    Built by `build_sync_plan`; one plan serves every training step.  `rotation` /
    `rotation_inv` are the permutation table of the randomized-cell
    schedule (None when rotation is off): sync step `t` mixes under
    replica order `rotation[t % P]` and scatters back through
    `rotation_inv[t % P]`.
    """

    strategy: str
    R: int
    levels: tuple[int, ...]
    rounds: tuple[int, ...]
    exact_fusion: bool
    compression: CompressionConfig
    rotation: Optional[tuple[tuple[int, ...], ...]] = None
    rotation_inv: Optional[tuple[tuple[int, ...], ...]] = None
    overlap: str = "none"
    failures: Optional[SyncFailureModel] = None
    aggregation: str = "mean"

    @property
    def rotated(self) -> bool:
        return self.rotation is not None

    @property
    def faulty(self) -> bool:
        """True when the plan injects at least one fault per step."""
        return self.failures is not None and self.failures.active

    @property
    def robust_consensus(self) -> bool:
        """True for the consensus-style robust reductions that replace
        the strategy's own mixing (rotation is a no-op for them)."""
        return self.aggregation in ("trimmed_mean", "coordinate_median")

    @property
    def overlapped(self) -> bool:
        return self.overlap == "one_step"

    @property
    def transmissions(self) -> int:
        """Per-sync payload sends under the point-to-point accounting model.

        Counts how many times the (possibly compressed) per-replica
        payload crosses a link per sync — the training-side analogue of
        the paper's message complexity.  Model: allreduce is the
        bandwidth-optimal ring (2(R-1) sends); hierarchical sends each
        active node's value up its fusion ladder and mirrors it down;
        ring gossip sends to both neighbors every round; multiscale
        pays per-cell ring rounds at every level plus the n-message
        dissemination down-pass (representative promotion is local).
        """
        R = self.R
        if R <= 1:
            return 0
        if self.strategy == "allreduce":
            return 2 * (R - 1)
        if self.strategy == "hierarchical" or (
            self.strategy == "multiscale" and self.exact_fusion
        ):
            # exact fusion evaluates as the grouped-mean ladder (§VII with
            # uniform occupancy) — same fusion traffic as `hierarchical`
            total, active = 0, R
            for l in reversed(self.levels):
                total += active
                active //= l
            return 2 * total
        if self.strategy == "ring":
            return 2 * R * self.rounds[0]
        total, active = 0, R
        for ax in range(len(self.levels) - 1, 0, -1):
            total += 2 * active * self.rounds[ax]
            active //= self.levels[ax]
        total += 2 * active * self.rounds[0]
        return total + R  # dissemination down-pass


def build_sync_plan(cfg: SyncConfig, R: int) -> SyncPlan:
    """Resolve a `SyncConfig` against a replica count into a `SyncPlan`.

    All configuration errors (level products, round counts, rotation
    parameters) surface here with actionable messages instead of as
    shape errors inside `execute_sync`.
    """
    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    if cfg.strategy in ("hierarchical", "multiscale"):
        levels = cfg.resolved_levels(R)
        rounds = cfg.resolved_rounds(levels)
    elif cfg.strategy == "ring":
        levels = ()
        rounds = (cfg.rounds[0] if cfg.rounds else 2 * R,)
    else:  # allreduce
        levels, rounds = (), ()

    rotation = rotation_inv = None
    if cfg.rotation_period > 0 and cfg.strategy in _GOSSIP and R > 1:
        perms, invs = rotation_schedule(R, cfg.rotation_period, cfg.rotation_seed)
        rotation = tuple(tuple(int(i) for i in p) for p in perms)
        rotation_inv = tuple(tuple(int(i) for i in p) for p in invs)

    if cfg.failures is not None:
        kc, ks, kb = fault_counts(cfg.failures, R)
        if kc + ks + kb >= R:
            raise ValueError(
                f"failure fractions leave no honest live replica: "
                f"churn {kc} + stragglers {ks} + byzantine {kb} >= R={R}"
            )
    if cfg.aggregation == "trimmed_mean":
        k_drop, k_trim = resolve_trim(cfg.failures, R)
        if R > 1 and R - k_drop - 2 * k_trim < 1:
            raise ValueError(
                f"trimmed_mean infeasible: dropping {k_drop} and trimming "
                f"2*{k_trim} of R={R} replicas leaves no value; lower the "
                f"failure fractions or use coordinate_median"
            )

    return SyncPlan(
        strategy=cfg.strategy,
        R=R,
        levels=levels,
        rounds=rounds,
        exact_fusion=cfg.exact_fusion,
        compression=cfg.compression,
        rotation=rotation,
        rotation_inv=rotation_inv,
        # one replica has nothing to overlap with — resolve to serialized
        overlap=cfg.overlap if R > 1 else "none",
        failures=cfg.failures,
        aggregation=cfg.aggregation,
    )


def tree_payload_bytes(grads) -> int:
    """Dense per-replica payload bytes of a replicated gradient dict
    (leading axis = replica; shapes and dtypes only)."""
    total = 0
    for leaf in grads.values():
        per_replica = 1
        for d in leaf.shape[1:]:
            per_replica *= d
        total += per_replica * leaf.element_size()
    return total


def plan_wire_bytes(plan: SyncPlan, grads: Any) -> float:
    """Modeled wire bytes of one sync: payload bytes x transmissions x
    the compression scheme's `wire_fraction` (static given shapes)."""
    return float(
        tree_payload_bytes(grads)
        * plan.transmissions
        * wire_fraction(plan.compression)
    )
