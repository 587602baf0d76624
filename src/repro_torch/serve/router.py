"""Decentralized request routing from gossiped load estimates.

Every replica is an ingress: a request lands on a uniformly random
replica, which picks the target using ONLY its own gossiped view of the
fleet (`ControlPlane.round().table` — replica r's estimate of every
replica's scalar load).  The policy is power-of-two-choices: sample two
candidate replicas, send to the one the ingress *believes* is less
loaded.  P2C is the classic trick that turns O(log n) max-load into
O(log log n) — and it is exactly as robust to the staleness/approx
error of gossiped estimates as the theory promises, which is what the
fleet benchmark measures against a centralized least-loaded oracle.

Host numpy, the reference's routers with the same `default_rng` streams.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PowerOfTwoRouter", "LeastLoadedOracle", "RandomRouter"]


class PowerOfTwoRouter:
    """P2C over per-ingress estimated loads (gossiped, stale, approximate)."""

    name = "p2c_gossip"

    def __init__(self, R: int, seed: int = 0):
        self.R = R
        self.rng = np.random.default_rng(seed)

    def route(self, ingress: int, est_scores: np.ndarray) -> int:
        """est_scores: (R,) the INGRESS replica's estimate table."""
        c1, c2 = self.rng.choice(self.R, size=2, replace=False)
        return int(c1 if est_scores[c1] <= est_scores[c2] else c2)


class LeastLoadedOracle:
    """Centralized scheduler baseline: exact least-loaded over TRUE loads
    (zero control-plane bytes, perfect global state — the upper bound a
    decentralized router is measured against)."""

    name = "oracle"

    def __init__(self, R: int, seed: int = 0):
        self.R = R
        self.rng = np.random.default_rng(seed)

    def route(self, ingress: int, true_scores: np.ndarray) -> int:
        lo = np.flatnonzero(true_scores == true_scores.min())
        return int(self.rng.choice(lo))


class RandomRouter:
    """Uniform random target (the no-information lower bound)."""

    name = "random"

    def __init__(self, R: int, seed: int = 0):
        self.R = R
        self.rng = np.random.default_rng(seed)

    def route(self, ingress: int, scores: np.ndarray) -> int:
        return int(self.rng.integers(self.R))
