"""Training: single-replica and decentralized train steps, the fault
tolerant `Trainer`, checkpoints, and the training failure-scenario
matrix."""
from .checkpoint import (
    latest_step, list_steps, restore_checkpoint, save_checkpoint,
)
from .scenarios import (
    TrainScenario, TrainScenarioResult, run_train_scenarios,
    train_scenario_matrix,
)
from .step import (
    clip_replicas_, consensus_distance, init_decentralized_state,
    init_train_state,
    make_decentralized_step, make_train_step, replica_grads, replicate,
    survivor_consensus_distance,
)
from .trainer import Trainer

__all__ = [
    "Trainer", "TrainScenario", "TrainScenarioResult", "clip_replicas_",
    "consensus_distance",
    "init_decentralized_state", "init_train_state", "latest_step",
    "list_steps",
    "make_decentralized_step", "make_train_step", "replica_grads",
    "replicate", "restore_checkpoint", "run_train_scenarios",
    "save_checkpoint", "survivor_consensus_distance",
    "train_scenario_matrix",
]
