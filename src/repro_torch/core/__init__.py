"""Multiscale gossip for decentralized averaging (Tsianos & Rabbat,
2010) on PyTorch and CUDA: the host-side plan (numpy), the bit-exact
threefry exchange schedule, and the batched executor whose value pass
runs in the hand-written `pair_apply` / `cell_mixing` kernels.
"""
from .convert import plan_from_reference
from .engine import EngineResult, execute_plan, fi_ticks, trials_error
from .gossip import (
    GOSSIP_BACKENDS,
    GossipResult,
    batched_graphs,
    gossip_core,
    gossip_until,
)
from .medium import CostModel, FailureModel
from .metrics import relative_error, theorem2_bound
from .multiscale import (
    LevelReport,
    MultiscaleResult,
    MultiscaleTrials,
    multiscale_gossip,
)
from .options import ExecOptions, resolve_device
from .partition import Partition, auto_levels, build_partition
from .plan import HierarchyPlan, LevelPlan, build_plan
from .rgg import (
    RGG_METHODS,
    Graph,
    connectivity_radius,
    grid_graph,
    random_geometric_graph,
)
from .schedule import (
    CsrGraphs,
    ExchangeSchedule,
    compose_schedule,
    dense_to_csr,
    flat_usage_to_dense,
    sample_schedule,
    sample_tick,
)
from .synchronous import SyncMultiscaleResult, synchronous_multiscale

__all__ = [
    "CostModel",
    "CsrGraphs",
    "EngineResult",
    "ExchangeSchedule",
    "ExecOptions",
    "FailureModel",
    "GOSSIP_BACKENDS",
    "Graph",
    "GossipResult",
    "HierarchyPlan",
    "LevelPlan",
    "LevelReport",
    "MultiscaleResult",
    "MultiscaleTrials",
    "Partition",
    "RGG_METHODS",
    "SyncMultiscaleResult",
    "auto_levels",
    "batched_graphs",
    "build_partition",
    "build_plan",
    "compose_schedule",
    "connectivity_radius",
    "dense_to_csr",
    "execute_plan",
    "fi_ticks",
    "flat_usage_to_dense",
    "gossip_core",
    "gossip_until",
    "grid_graph",
    "multiscale_gossip",
    "plan_from_reference",
    "random_geometric_graph",
    "relative_error",
    "resolve_device",
    "sample_schedule",
    "sample_tick",
    "synchronous_multiscale",
    "theorem2_bound",
    "trials_error",
]
