"""Multiscale gossip — the paper's Algorithm 1.

A thin facade over the plan/execute simulation core:

* `core.plan.build_plan` runs the ahead-of-time pass on the host —
  recursive partition, induced-subgraph batches, overlay grid edges,
  representative election, batched greedy-geographic routes and
  route-incidence CSR attribution;
* `core.engine.execute_plan` runs all K levels on the card (batched
  gossip, Alg.-1 line-16 reweighting, promotion and dissemination as
  gathers), with the Monte-Carlo trials as a batch axis.

Algorithm recap (paper Alg. 1):

  1. level k (finest): randomized gossip inside every cell's induced
     subgraph; elect a representative per cell; reweight its value by
     |cell| * (#present sibling cells) / |parent|  (Alg. 1 line 16).
  2. levels j = k-1 .. 1: representatives form a grid graph per level-j
     cell; every exchange costs 2 * hops single-hop transmissions via
     greedy geographic routing on the base graph.
  3. after the level-1 grid converges, every level-2 representative
     disseminates its value to its cell (n messages total).

`weighted=True` is the exact-mass variant: values travel as (w*x, w)
pairs.  `fixed_ticks_scale` > 0 selects MultiscaleGossipFI (§VI): every
graph at a level runs a deterministic number of exchanges derived from
the worst-case graph size, with no convergence oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from .engine import EngineResult, execute_plan, trials_error
from .medium import CostModel, FailureModel, MediumCost
from .options import ExecOptions, resolve_device
from .partition import Partition
from .plan import HierarchyPlan, build_plan
from .rgg import Graph

__all__ = [
    "MultiscaleResult",
    "MultiscaleTrials",
    "LevelReport",
    "multiscale_gossip",
]


@dataclasses.dataclass
class LevelReport:
    level: int
    num_graphs: int
    messages: int
    max_ticks: int
    converged_frac: float
    max_hops: int          # longest routed exchange at this level
    graph_sizes: tuple     # (min, mean, max) nodes per graph


@dataclasses.dataclass
class MultiscaleResult:
    x_final: np.ndarray       # (n,) estimate at every node
    messages: int             # total single-hop transmissions
    levels: list[LevelReport]
    node_sends: np.ndarray    # (n,) transmissions attributed per node
    rep_counts: np.ndarray    # (n,) #times each node served as representative
    disconnected_cells: int   # finest-level cells whose subgraph was disconnected
    partition: Partition
    cost: Optional[MediumCost] = None  # priced medium cost (CostModel runs)

    def error(self, x0: np.ndarray) -> float:
        """Paper's final relative error ||x_final - avg|| / ||x0||."""
        avg = float(np.mean(x0))
        return float(np.linalg.norm(self.x_final - avg) / np.linalg.norm(x0))


@dataclasses.dataclass
class MultiscaleTrials:
    """T Monte-Carlo trials from one plan execution: trial t equals a
    single run with seed `seeds[t]` on `plan`."""

    x_final: np.ndarray       # (T, n)
    messages: np.ndarray      # (T,)
    node_sends: np.ndarray    # (T, n)
    seeds: tuple              # per-trial gossip seeds
    levels: list[LevelReport]  # trial-averaged per-level reports
    rep_counts: np.ndarray    # (n,) — shared: election is part of the plan
    disconnected_cells: int
    partition: Partition
    backend: str
    cost: Optional[MediumCost] = None  # per-trial priced cost (CostModel runs)

    @property
    def trials(self) -> int:
        return int(self.x_final.shape[0])

    def error(self, x0: np.ndarray) -> np.ndarray:
        """(T,) per-trial relative error; x0 is (n,) or (T, n)."""
        return trials_error(self.x_final, x0)


def _level_reports(
    plan: HierarchyPlan, res: EngineResult, n: int
) -> list[LevelReport]:
    """Per-level reports (averaged over trials for T > 1)."""
    out = []
    for li, lp in enumerate(plan.levels):
        out.append(LevelReport(
            level=lp.level,
            num_graphs=lp.num_graphs,
            messages=int(res.level_messages[:, li].mean()),
            max_ticks=int(res.level_ticks[:, li].max()),
            converged_frac=float(res.level_converged[:, li].mean()),
            max_hops=lp.max_hops,
            graph_sizes=lp.graph_sizes,
        ))
    out.append(LevelReport(
        level=0, num_graphs=0, messages=n if plan.disseminate else 0,
        max_ticks=0, converged_frac=1.0, max_hops=1, graph_sizes=(0, 0.0, 0),
    ))
    return out


def multiscale_gossip(
    g: Graph,
    x0: np.ndarray,
    *,
    eps: float = 1e-4,
    k: Optional[int] = None,
    a: float = 2.0 / 3.0,
    cell_max: float = 8.0,
    seed: int = 0,
    rep_mode: str = "random",
    weighted: bool = False,
    fixed_ticks_scale: float = 0.0,
    trials: int = 1,
    plan: Optional[HierarchyPlan] = None,
    options: Optional[ExecOptions] = None,
    failures: Optional[FailureModel] = None,
    cost: Optional[CostModel] = None,
) -> Union[MultiscaleResult, MultiscaleTrials]:
    """Run multiscale gossip (Alg. 1); see module docstring.

    With `trials=T` all T trials execute together (seeds `seed ..
    seed+T-1`) and a `MultiscaleTrials` is returned.  Pass `plan=` to
    reuse a prebuilt `HierarchyPlan` (then `k`, `a`, `cell_max`,
    `rep_mode` come from the plan and `seed` only drives the gossip
    randomness).  `options` (`ExecOptions`) selects backend / device /
    process mesh / check cadence / tick budget (with a mesh, every rank
    calls this alike and gets the whole result); `failures` carries the
    paper's loss model plus churn / straggler / regional / Byzantine
    scenarios; `cost` (`CostModel`) prices the run onto the wireless
    medium into `.cost` without perturbing the exchange trajectory.
    """
    if options is None:
        options = ExecOptions()
    resolve_device(options.device)
    if plan is None:
        plan = build_plan(
            g, k=k, a=a, cell_max=cell_max, seed=seed, rep_mode=rep_mode
        )
    n = g.n
    seeds = tuple(int(seed) + t for t in range(trials))
    res = execute_plan(
        plan, x0, eps=eps, seeds=seeds, weighted=weighted,
        fixed_ticks_scale=fixed_ticks_scale,
        options=options, failures=failures, cost=cost,
    )
    reports = _level_reports(plan, res, n)
    if trials == 1:
        return MultiscaleResult(
            x_final=res.x_final[0],
            messages=int(res.messages[0]),
            levels=reports,
            node_sends=res.node_sends[0],
            rep_counts=plan.rep_counts.copy(),
            disconnected_cells=plan.disconnected_cells,
            partition=plan.partition,
            cost=res.cost,
        )
    return MultiscaleTrials(
        x_final=res.x_final,
        messages=res.messages,
        node_sends=res.node_sends,
        seeds=seeds,
        levels=reports,
        rep_counts=plan.rep_counts.copy(),
        disconnected_cells=plan.disconnected_cells,
        partition=plan.partition,
        backend=options.backend,
        cost=res.cost,
    )
