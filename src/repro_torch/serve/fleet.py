"""Simulated N-replica serving fleet, gossip-coordinated.

Every replica runs the REAL scheduling stack — `BatchingEngine` over a
`PageTable` (admission, up-front page reservation, per-step retirement)
— with a `SimBackend` standing in for the model, so fleet-scale
behavior (queueing, page pressure, admission latency) is produced by
the production code paths, not a queueing abstraction.

Per tick: requests arrive (Poisson), each lands on a random ingress
replica and is routed by the configured policy; every replica advances
its engine `speed` steps; every `gossip_interval` ticks the control
plane runs one multiscale round and refreshes each replica's estimate
table.  `p2c_gossip` routes from those (stale, approximate) estimates;
`oracle` is the centralized least-loaded scheduler with perfect state
and zero control bytes; `random` is the no-information floor.

Host code, the reference's line for line; the control plane's rounds run
as `options` says (`ControlPlane`: the card unless given).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import ExecOptions
from .batching import BatchingEngine, SimBackend
from .control_plane import LOAD_FIELDS, ControlPlane
from .kv_pages import PageTable
from .router import LeastLoadedOracle, PowerOfTwoRouter, RandomRouter

__all__ = ["FleetConfig", "FleetResult", "run_fleet", "ROUTERS"]

ROUTERS = ("p2c_gossip", "oracle", "random")


@dataclasses.dataclass
class FleetConfig:
    replicas: int = 16
    slots_per_replica: int = 4
    pages_per_replica: int = 48
    page_size: int = 8
    pages_per_slot: int = 12
    max_prompt_len: int = 16
    ticks: int = 240
    arrival_rate: float = 0.0        # requests/tick; 0 -> near-saturation
    prompt_len: tuple = (4, 16)      # uniform [lo, hi)
    decode_len: tuple = (8, 48)
    router: str = "p2c_gossip"
    gossip_interval: int = 4
    gossip_eps: float = 1e-4
    speeds: Optional[tuple] = None   # per-replica engine steps per tick
    seed: int = 0

    def resolved_rate(self) -> float:
        """Default workload: ~90% of fleet decode capacity, so routing
        quality (not raw capacity) decides throughput."""
        if self.arrival_rate > 0:
            return self.arrival_rate
        speeds = self.resolved_speeds()
        cap = sum(speeds) * self.slots_per_replica  # tokens/tick ceiling
        mean_len = (self.decode_len[0] + self.decode_len[1]) / 2.0
        return 0.9 * cap / mean_len

    def resolved_speeds(self) -> tuple:
        if self.speeds is not None:
            if len(self.speeds) != self.replicas:
                raise ValueError("speeds must have one entry per replica")
            return tuple(int(s) for s in self.speeds)
        # mildly heterogeneous fleet: every 4th replica is 2x fast
        return tuple(2 if r % 4 == 0 else 1 for r in range(self.replicas))


@dataclasses.dataclass
class FleetResult:
    router: str
    ticks: int
    tokens: int
    completed: int
    submitted: int
    throughput: float                # tokens / tick
    admission_latency_mean: float    # ticks, completed requests
    admission_latency_p95: float
    page_utilization_mean: float
    queue_depth_mean: float
    control_rounds: int
    control_messages: int
    control_bytes: int
    bytes_per_round: float
    payload_values: int
    level_messages: Optional[np.ndarray]   # (L,) last round's per-level split


def run_fleet(cfg: FleetConfig,
              options: Optional[ExecOptions] = None) -> FleetResult:
    """Simulate the fleet for `cfg.ticks` ticks; `options` goes to the
    control plane (the p2c_gossip router's only)."""
    R = cfg.replicas
    rng = np.random.default_rng(cfg.seed)
    speeds = cfg.resolved_speeds()
    rate = cfg.resolved_rate()

    engines = []
    for r in range(R):
        table = PageTable(
            num_pages=cfg.pages_per_replica, page_size=cfg.page_size,
            num_slots=cfg.slots_per_replica,
            pages_per_slot=cfg.pages_per_slot,
        )
        backend = SimBackend(cfg.slots_per_replica)
        # SimBackend never emits EOS: lifetimes come from max_new_tokens
        engines.append(
            BatchingEngine(backend, table, eos_id=-1, seed=cfg.seed + r)
        )

    if cfg.router == "p2c_gossip":
        router = PowerOfTwoRouter(R, seed=cfg.seed + 101)
        cp = ControlPlane(R, full_view=True, seed=cfg.seed,
                          eps=cfg.gossip_eps, options=options)
    elif cfg.router == "oracle":
        router, cp = LeastLoadedOracle(R, seed=cfg.seed + 101), None
    elif cfg.router == "random":
        router, cp = RandomRouter(R, seed=cfg.seed + 101), None
    else:
        raise ValueError(f"unknown router {cfg.router!r}; one of {ROUTERS}")

    # replica r's gossiped estimate of every replica's load score; until
    # the first round completes, everyone assumes a uniformly idle fleet
    est_tables = np.zeros((R, R))
    last_level_messages = None
    submitted = 0
    page_util, queue_depth = [], []

    for tick in range(cfg.ticks):
        # -- gossip round (decentralized router only) --------------------
        if cp is not None and tick % cfg.gossip_interval == 0:
            loads = np.stack([
                [e.load_vector()[f] for f in LOAD_FIELDS] for e in engines
            ])
            scores = np.array([e.load_score() for e in engines])
            rr = cp.round(loads, scores, round_idx=tick)
            est_tables = rr.table
            last_level_messages = rr.level_messages

        # -- arrivals + routing ------------------------------------------
        true_scores = np.array([e.load_score() for e in engines])
        for _ in range(rng.poisson(rate)):
            ingress = int(rng.integers(R))
            plen = int(rng.integers(*cfg.prompt_len))
            dlen = int(rng.integers(*cfg.decode_len))
            if cfg.router == "p2c_gossip":
                target = router.route(ingress, est_tables[ingress])
            else:
                target = router.route(ingress, true_scores)
            engines[target].submit(np.zeros(plen, np.int32), dlen)
            submitted += 1

        # -- serve --------------------------------------------------------
        for r, e in enumerate(engines):
            for _ in range(speeds[r]):
                if not e.idle:
                    e.step()

        page_util.append(np.mean([e.table.utilization for e in engines]))
        queue_depth.append(np.mean([e.queue_depth for e in engines]))

    tokens = sum(e.tokens_generated for e in engines)
    done = [r for e in engines for r in e.completed]
    lat = np.array([r.admission_latency for r in done]) if done else np.array([0.0])
    return FleetResult(
        router=cfg.router,
        ticks=cfg.ticks,
        tokens=tokens,
        completed=len(done),
        submitted=submitted,
        throughput=tokens / max(1, cfg.ticks),
        admission_latency_mean=float(lat.mean()),
        admission_latency_p95=float(np.percentile(lat, 95)),
        page_utilization_mean=float(np.mean(page_util)),
        queue_depth_mean=float(np.mean(queue_depth)),
        control_rounds=cp.rounds_run if cp else 0,
        control_messages=cp.total_messages if cp else 0,
        control_bytes=cp.total_bytes if cp else 0,
        bytes_per_round=(cp.total_bytes / cp.rounds_run) if cp else 0.0,
        payload_values=cp.payload_values if cp else 0,
        level_messages=last_level_messages,
    )
