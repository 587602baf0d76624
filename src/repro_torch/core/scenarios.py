"""Declarative failure-scenario matrix for multiscale gossip.

The paper evaluates robustness with a single knob (per-hop message loss,
§VI-C-2).  Real wireless deployments fail in richer, correlated ways —
nodes churn out mid-gossip, heterogeneous links straggle, a storm takes
out a whole region, a buggy node stops applying updates.  This module
turns those into a declarative matrix of named `Scenario`s, each just a
`FailureModel` (`core.medium`), and replays ONE shared plan under every
scenario: the engine perturbs the presampled exchange schedule and
reruns the value pass, so a scenario run is exactly the reliable run's
schedule with the events injected (same plan, same gossip seeds).

Every scenario reports the achieved relative error (all nodes and
surviving nodes — dead nodes keep their last value, which is the honest
deployment read-out but unfair to the algorithm) and, when a
`CostModel` is passed, the priced medium cost.

Scenario event times are fractions of the finest level's tick budget,
so the matrix runs in fixed-iterations mode (`fixed_ticks_scale > 0`,
the paper's MultiscaleGossipFI) where that budget is well-defined.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .engine import trials_error
from .medium import CostModel, FailureModel, MediumCost, failure_sets
from .options import ExecOptions
from .plan import HierarchyPlan, build_plan
from .rgg import Graph

__all__ = [
    "Scenario",
    "ScenarioResult",
    "scenario_matrix",
    "run_scenario_matrix",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named cell of the failure matrix."""

    name: str
    failures: Optional[FailureModel] = None  # None = reliable baseline
    description: str = ""


def scenario_matrix(
    *,
    loss_p: Optional[float] = None,
    churn_fraction: float = 0.2,
    straggler_fraction: float = 0.3,
    regional_radius: float = 0.25,
    drop_fraction: float = 0.1,
    seed: int = 0,
) -> list[Scenario]:
    """The default 5-scenario matrix: reliable baseline plus one
    scenario per failure family.  `loss_p` (if set) applies to every
    scenario on top of its events — the paper's loss model composes
    with the richer failures."""
    fm = dict(loss_p=loss_p, seed=seed)
    return [
        Scenario(
            "baseline",
            FailureModel(**fm) if loss_p is not None else None,
            "reliable network (paper's default)",
        ),
        Scenario(
            "churn",
            FailureModel(churn_fraction=churn_fraction, churn_time=0.5, **fm),
            f"{churn_fraction:.0%} of nodes leave halfway through the "
            "finest level and stay down",
        ),
        Scenario(
            "stragglers",
            FailureModel(straggler_fraction=straggler_fraction,
                         straggler_success=0.25, **fm),
            f"{straggler_fraction:.0%} slow nodes: their exchanges "
            "succeed 25% of the time at full cost",
        ),
        Scenario(
            "regional",
            FailureModel(regional_radius=regional_radius,
                         regional_window=(0.25, 0.75), **fm),
            f"radius-{regional_radius} outage around a random epicenter "
            "for the middle half of the finest level",
        ),
        Scenario(
            "byzantine",
            FailureModel(drop_fraction=drop_fraction, **fm),
            f"{drop_fraction:.0%} of nodes never apply incoming updates",
        ),
    ]


@dataclasses.dataclass
class ScenarioResult:
    """One scenario's replay: per-trial errors and priced cost."""

    scenario: Scenario
    errors: np.ndarray             # (T,) relative error, all nodes
    survivor_errors: np.ndarray    # (T,) error over non-dead nodes only
    messages: np.ndarray           # (T,) logical single-hop transmissions
    cost: Optional[MediumCost]     # priced medium cost (cost= runs)
    seeds: tuple

    @property
    def err_mean(self) -> float:
        return float(self.errors.mean())

    @property
    def err_std(self) -> float:
        return float(self.errors.std())

    @property
    def energy_mean(self) -> float:
        if self.cost is None:
            return float(self.messages.mean())
        return float(self.cost.energy.mean())


def _survivor_error(x_final, x0, live):
    """Relative error against the TRUE all-node average, measured only
    at surviving nodes (dead nodes freeze their last value)."""
    x0 = np.asarray(x0, np.float64)
    avg = x0.mean(axis=-1, keepdims=True)
    xf = np.asarray(x_final, np.float64)[:, live]
    num = np.linalg.norm(xf - avg, axis=-1)
    den = np.linalg.norm(
        np.broadcast_to(x0, np.asarray(x_final).shape)[:, live], axis=-1)
    return num / np.maximum(den, 1e-30)


def run_scenario_matrix(
    g: Graph,
    x0: np.ndarray,
    scenarios: Optional[Sequence[Scenario]] = None,
    *,
    eps: float = 1e-4,
    trials: int = 4,
    seed: int = 0,
    weighted: bool = False,
    fixed_ticks_scale: float = 1.0,
    options: Optional[ExecOptions] = None,
    cost: Optional[CostModel] = None,
    plan: Optional[HierarchyPlan] = None,
) -> list[ScenarioResult]:
    """Replay every scenario over ONE shared plan and gossip-seed set.

    Runs in fixed-iterations mode (`fixed_ticks_scale > 0` required:
    scenario event times are fractions of the finest level's budget,
    which the eps-oracle mode leaves unbounded).  The reliable baseline
    and every scenario share the plan and the per-trial seeds, so
    differences are attributable to the injected events alone.
    """
    if fixed_ticks_scale <= 0:
        raise ValueError(
            "run_scenario_matrix requires fixed_ticks_scale > 0 "
            "(scenario event times are fractions of the fixed budget)")
    from .multiscale import multiscale_gossip

    if scenarios is None:
        scenarios = scenario_matrix()
    if plan is None:
        plan = build_plan(g, seed=seed)
    out = []
    for sc in scenarios:
        res = multiscale_gossip(
            g, x0, eps=eps, seed=seed, trials=trials, weighted=weighted,
            fixed_ticks_scale=fixed_ticks_scale, plan=plan,
            options=options, failures=sc.failures, cost=cost,
        )
        live = np.ones(g.n, bool)
        if sc.failures is not None and sc.failures.has_scenario:
            sets = failure_sets(sc.failures, g.n, coords=g.coords)
            live &= ~sets["churned"]
            if sc.failures.regional_window[1] > 1.0:
                live &= ~sets["regional"]
        # trials=1 returns a MultiscaleResult with unbatched shapes
        xf = np.atleast_2d(np.asarray(res.x_final))
        out.append(ScenarioResult(
            scenario=sc,
            errors=trials_error(xf, x0),
            survivor_errors=_survivor_error(xf, x0, live),
            messages=np.atleast_1d(np.asarray(res.messages, np.int64)),
            cost=res.cost,
            seeds=getattr(res, "seeds", (int(seed),)),
        ))
    return out
