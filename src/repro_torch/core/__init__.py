"""Multiscale gossip for decentralized averaging (Tsianos & Rabbat,
2010) on PyTorch and CUDA: the host-side plan (numpy) and its
content-addressed cache, the bit-exact threefry exchange schedule, and
the batched executor whose value pass runs in the hand-written
`pair_apply` / `cell_mixing` kernels (its Monte-Carlo trials and each
level's graphs shardable over a `torch.distributed` process mesh,
`ExecOptions(mesh=)`), the wireless failure and cost models, and the
baselines the paper compares against.
"""
from .baselines import (
    BaselineResult,
    geographic_gossip,
    path_averaging,
    standard_gossip,
)
from .convert import plan_from_reference
from .engine import EngineResult, execute_plan, fi_ticks, trials_error
from .failures import handshake_cost
from .gossip import (
    GOSSIP_BACKENDS,
    GossipResult,
    batched_graphs,
    gossip_core,
    gossip_until,
)
from .medium import (
    CostModel,
    FailureCtx,
    FailureModel,
    MediumCost,
    expected_retransmissions,
    failure_sets,
    level_edge_messages,
    price_edge_messages,
    price_messages,
    route_edge_transmissions,
)
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
from .plan_cache import (
    PLAN_CACHE_VERSION,
    graph_digest_spec,
    graph_spec,
    load_plan,
    plan_key,
    setup_plan,
    store_plan,
)
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
from .routing import accumulate_route_sends, batched_greedy_routes
from .scenarios import (
    Scenario,
    ScenarioResult,
    run_scenario_matrix,
    scenario_matrix,
)
from .synchronous import SyncMultiscaleResult, synchronous_multiscale

__all__ = [
    "BaselineResult",
    "CostModel",
    "CsrGraphs",
    "EngineResult",
    "ExchangeSchedule",
    "ExecOptions",
    "FailureCtx",
    "FailureModel",
    "GOSSIP_BACKENDS",
    "GossipResult",
    "Graph",
    "HierarchyPlan",
    "LevelPlan",
    "LevelReport",
    "MediumCost",
    "MultiscaleResult",
    "MultiscaleTrials",
    "PLAN_CACHE_VERSION",
    "Partition",
    "RGG_METHODS",
    "Scenario",
    "ScenarioResult",
    "SyncMultiscaleResult",
    "accumulate_route_sends",
    "auto_levels",
    "batched_graphs",
    "batched_greedy_routes",
    "build_partition",
    "build_plan",
    "compose_schedule",
    "connectivity_radius",
    "dense_to_csr",
    "execute_plan",
    "expected_retransmissions",
    "failure_sets",
    "fi_ticks",
    "flat_usage_to_dense",
    "geographic_gossip",
    "graph_digest_spec",
    "graph_spec",
    "gossip_core",
    "gossip_until",
    "grid_graph",
    "handshake_cost",
    "level_edge_messages",
    "load_plan",
    "multiscale_gossip",
    "path_averaging",
    "plan_from_reference",
    "plan_key",
    "price_edge_messages",
    "price_messages",
    "random_geometric_graph",
    "relative_error",
    "resolve_device",
    "route_edge_transmissions",
    "run_scenario_matrix",
    "sample_schedule",
    "sample_tick",
    "scenario_matrix",
    "setup_plan",
    "standard_gossip",
    "store_plan",
    "synchronous_multiscale",
    "theorem2_bound",
    "trials_error",
]
