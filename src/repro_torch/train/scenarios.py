"""Declarative failure-scenario matrix for decentralized TRAINING.

Training-stack mirror of `core.scenarios`: one decentralized training
configuration — same model, optimizer, initial parameters, synthetic
data stream, and sync strategy — run under a matrix of named
replica-failure scenarios (`dist.SyncFailureModel`) and aggregation
modes.  Everything about the mixing plan (strategy, levels, rounds,
compression, rotation) is shared across cells; only the `failures` /
`aggregation` fields vary, so degradation is attributable to the
injected faults and the chosen defense alone.

Each cell reports the full metric history of a short end-to-end run
(`make_decentralized_step` metrics incl. the degradation trio:
survivor consensus error, effective replica fraction, rejected-gradient
count) plus summary properties.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..dist import SyncConfig, SyncFailureModel
from ..optim.optimizers import Optimizer
from .step import init_decentralized_state, make_decentralized_step, replicate

__all__ = [
    "TrainScenario",
    "TrainScenarioResult",
    "train_scenario_matrix",
    "run_train_scenarios",
]


@dataclasses.dataclass(frozen=True)
class TrainScenario:
    """One named cell of the training failure matrix."""

    name: str
    failures: Optional[SyncFailureModel] = None  # None = reliable baseline
    aggregation: str = "mean"
    description: str = ""


def train_scenario_matrix(
    *,
    churn_fraction: float = 0.25,
    straggler_fraction: float = 0.25,
    byzantine_fraction: float = 0.125,
    byzantine_scale: float = 10.0,
    seed: int = 0,
) -> list[TrainScenario]:
    """The default 4-scenario matrix: reliable baseline plus one cell
    per fault family, each paired with its natural defense —
    survivor-weighted mass renormalization for absence faults (churn,
    stragglers), trimmed-mean for adversarial ones (Byzantine)."""
    return [
        TrainScenario(
            "baseline", None, "mean",
            "reliable replicas, plain mixing",
        ),
        TrainScenario(
            "churn",
            SyncFailureModel(churn_fraction=churn_fraction, seed=seed),
            "survivor_weighted",
            f"{churn_fraction:.0%} of replicas absent each sync; "
            "doubly-stochastic mass renormalized over survivors",
        ),
        TrainScenario(
            "straggler",
            SyncFailureModel(straggler_fraction=straggler_fraction, seed=seed),
            "survivor_weighted",
            f"{straggler_fraction:.0%} of replicas miss each sync round",
        ),
        TrainScenario(
            "byzantine",
            SyncFailureModel(
                byzantine_fraction=byzantine_fraction,
                byzantine_scale=byzantine_scale, seed=seed,
            ),
            "trimmed_mean",
            f"{byzantine_fraction:.0%} of replicas transmit corrupted "
            f"gradients (x-{byzantine_scale:g}); trimmed-mean defense",
        ),
    ]


@dataclasses.dataclass
class TrainScenarioResult:
    """One scenario's end-to-end run: the per-step metric history."""

    scenario: TrainScenario
    history: list  # per-step dicts of float metrics

    @property
    def losses(self) -> np.ndarray:
        return np.array([h["loss"] for h in self.history])

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])

    @property
    def loss_drop(self) -> float:
        """first loss - last loss (> 0 means training progressed)."""
        return float(self.losses[0] - self.losses[-1])

    @property
    def survivor_error_final(self) -> float:
        return float(self.history[-1]["survivor_consensus_error"])

    @property
    def effective_replica_fraction_mean(self) -> float:
        return float(np.mean(
            [h["effective_replica_fraction"] for h in self.history]))

    @property
    def rejected_gradients_total(self) -> float:
        return float(sum(h["rejected_gradient_count"] for h in self.history))


def run_train_scenarios(
    model_cfg,
    optimizer: Optimizer,
    lr_fn: Callable,
    base_sync: SyncConfig,
    num_replicas: int,
    params,
    data,
    scenarios: Optional[Sequence[TrainScenario]] = None,
    *,
    num_steps: int = 6,
    clip_norm: float = 1.0,
    mesh=None,
    device="cuda",
) -> list[TrainScenarioResult]:
    """Run every scenario end-to-end from the SAME initial state, on
    `device` (the card unless "cpu" is asked for).

    params: the base (unreplicated) parameters, a `Transformer` or a
        flat dict; each cell starts from its own R copies of them.
    data: object with ``batch_at(step) -> dict`` of host arrays whose
        leading axis is the global batch (``R * per_replica``); batches
        are deterministic in the step, so every cell consumes the exact
        same stream.
    base_sync: the shared mixing configuration; each scenario overrides
        only its `failures` / `aggregation` fields.
    """
    if scenarios is None:
        scenarios = train_scenario_matrix()
    R = num_replicas
    out = []
    for sc in scenarios:
        sync = dataclasses.replace(
            base_sync, failures=sc.failures, aggregation=sc.aggregation
        )
        step = make_decentralized_step(
            model_cfg, optimizer, lr_fn, sync, R,
            clip_norm=clip_norm, mesh=mesh, device=device,
        )
        state = init_decentralized_state(replicate(params, R), optimizer,
                                         sync=sync)
        history = []
        for s in range(num_steps):
            b = data.batch_at(s)
            batch = {k: v.reshape(R, -1, *v.shape[1:]) for k, v in b.items()}
            state, m = step(state, batch)
            history.append({k: float(v) for k, v in m.items()})
        del state  # one cell's state at a time
        out.append(TrainScenarioResult(scenario=sc, history=history))
    return out
