from .batching import BatchingEngine, ModelBackend, Request, SimBackend
from .control_plane import LOAD_FIELDS, ControlPlane, RoundResult
from .engine import Generator, make_serve_step
from .fleet import ROUTERS, FleetConfig, FleetResult, run_fleet
from .kv_pages import PageTable
from .router import LeastLoadedOracle, PowerOfTwoRouter, RandomRouter

__all__ = [
    "Generator",
    "make_serve_step",
    "PageTable",
    "Request",
    "BatchingEngine",
    "ModelBackend",
    "SimBackend",
    "ControlPlane",
    "RoundResult",
    "LOAD_FIELDS",
    "PowerOfTwoRouter",
    "LeastLoadedOracle",
    "RandomRouter",
    "FleetConfig",
    "FleetResult",
    "run_fleet",
    "ROUTERS",
]
