"""repro_torch.dist — decentralized gradient synchronization (the paper's
multiscale gossip applied to data-parallel training replicas), on dicts
of tensors with a leading replica axis.

Public surface:
  SyncConfig / build_sync_plan  static plan resolution (plan/execute split)
  SyncPlan / execute_sync       compress->faults->rotate->mix executor
  async_execute_sync            one-step-delayed (overlapped) pipeline stage
  execute_sync_sharded          the same mix as explicit collectives, each
                                rank of a replica DeviceMesh holding one row
  collectives                   ppermute / psum / pmean / pmax / broadcast /
                                all_gather over named mesh dims, and their
                                account of calls and bytes
  sync_gradients                one-shot strategy-dispatched mixing
  suggest_levels                the n^(2/3) recursive-partition rule
  rotation_schedule             step-indexed randomized-cell permutations
  compression                   error-feedback gradient compression
  SyncFailureModel              per-step churn/straggler/Byzantine injection
  AGGREGATIONS / robust         fault-tolerant aggregation modes
"""
from . import collectives
from .async_sync import async_execute_sync, execute_sync_sharded, init_inflight
from .compression import (
    CompressionConfig, compress, decompress, init_residual, wire_fraction,
)
from .failures import (
    ReplicaFaults, SyncFailureModel, apply_payload_faults, fault_counts,
    replica_fault_masks,
)
from .gossip_sync import STRATEGIES, SyncConfig, execute_sync, sync_gradients
from .plan import (
    AGGREGATIONS, OVERLAP_MODES, SyncPlan, build_sync_plan, plan_wire_bytes,
    tree_payload_bytes,
)
from .robust import (
    masked_coordinate_median, masked_trimmed_mean, resolve_trim,
    survivor_weighted_fn, tree_robust_reduce,
)
from .topology import (
    complete_matrix, default_rounds, hierarchy_matrix, is_doubly_stochastic,
    ring_matrix, rotation_schedule, suggest_levels,
)

__all__ = [
    "AGGREGATIONS",
    "OVERLAP_MODES",
    "ReplicaFaults",
    "SyncConfig",
    "SyncFailureModel",
    "SyncPlan",
    "apply_payload_faults",
    "fault_counts",
    "masked_coordinate_median",
    "masked_trimmed_mean",
    "replica_fault_masks",
    "resolve_trim",
    "survivor_weighted_fn",
    "tree_robust_reduce",
    "async_execute_sync",
    "build_sync_plan",
    "collectives",
    "execute_sync_sharded",
    "execute_sync",
    "init_inflight",
    "plan_wire_bytes",
    "tree_payload_bytes",
    "sync_gradients",
    "STRATEGIES",
    "suggest_levels",
    "rotation_schedule",
    "ring_matrix",
    "complete_matrix",
    "hierarchy_matrix",
    "default_rounds",
    "is_doubly_stochastic",
    "CompressionConfig",
    "compress",
    "decompress",
    "init_residual",
    "wire_fraction",
]
