"""Multiscale-gossip control plane for a serving fleet.

Each replica holds a local load vector (queue depth, active slots, free
pages, recent tok/s — `BatchingEngine.load_vector`).  Replicas average
these vectors over the paper's n^(2/3) hierarchy so every replica
converges to fleet-wide estimates WITHOUT a centralized scheduler: the
replica set is embedded as a random geometric graph (replicas within
radio/rack range gossip directly, distant ones via the overlay routes —
the Geographic-Gossip idiom), the hierarchy depth comes from
`dist.topology.suggest_levels`, and each control round is one pass of
the plan/execute simulation core (`core.build_plan` /
`core.execute_plan`) with its presampled exchange schedule: on the card
each chunk of a round is one `sample_chunk` and one `pair_apply` kernel
launch (`ExecOptions(backend="cuda")`, the default); on the CPU the
caller passes ``ExecOptions(backend="ref", device="cpu")``.

The whole payload rides ONE schedule: all vector fields are executed as
"trials" of `execute_plan` sharing a single round seed, in the paper's
fixed-iterations mode (`fixed_ticks_scale`, §VI) so termination is
data-independent — every field is mixed by the identical exchange
sequence, i.e. exactly one packet per exchange carries the full vector.
Message counts therefore price the round in transmissions, and bytes =
messages x payload values x `bytes_per_value` (the Nokleby et al.
point: consensus cost in bytes, not messages).

With `full_view=True` the payload additionally carries a per-replica
load table seeded as R * score_j at replica j (mean = score_j), so
after a round every replica holds an estimate of EVERY replica's scalar
load — the input to power-of-two-choices routing (`serve.router`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import (
    ExecOptions,
    build_plan,
    execute_plan,
    random_geometric_graph,
    resolve_device,
)
from ..dist.topology import suggest_levels

__all__ = ["LOAD_FIELDS", "RoundResult", "ControlPlane"]

LOAD_FIELDS = ("queue_depth", "active_slots", "free_pages", "tok_s")


@dataclasses.dataclass
class RoundResult:
    """Per-replica estimates + cost accounting of one control round."""

    summary: np.ndarray            # (R, F) each replica's fleet-mean estimate
    table: Optional[np.ndarray]    # (R, R) replica r's estimate of score_j
    messages: int                  # single-hop transmissions this round
    control_bytes: int             # messages * payload_values * bytes_per_value
    level_messages: np.ndarray     # (L,) per hierarchy level
    level_ticks: np.ndarray        # (L,) gossip ticks per level
    payload_values: int


class ControlPlane:
    """Fleet-wide load averaging over the multiscale hierarchy.

    R replicas, hierarchy depth `len(suggest_levels(R))`, one
    `HierarchyPlan` built once and reused every round.  `options` says
    how a round executes: the card with backend "cuda" unless given
    (the reference's `backend`).
    """

    def __init__(self, R: int, *, full_view: bool = True, seed: int = 0,
                 eps: float = 1e-4, bytes_per_value: int = 4,
                 fixed_ticks_scale: float = 1.0,
                 options: Optional[ExecOptions] = None):
        if R < 2:
            raise ValueError(f"control plane needs >= 2 replicas, got {R}")
        self.R = R
        self.full_view = bool(full_view)
        self.seed = int(seed)
        self.eps = float(eps)
        self.bytes_per_value = int(bytes_per_value)
        if fixed_ticks_scale <= 0:
            # eps-oracle termination is data-dependent: different payload
            # fields would stop at different ticks and the one-packet-per-
            # exchange byte accounting would be wrong
            raise ValueError("control plane requires fixed_ticks_scale > 0")
        self.fixed_ticks_scale = float(fixed_ticks_scale)
        self.options = options if options is not None else ExecOptions()
        resolve_device(self.options.device)  # no card: raise, before any work
        self.levels = suggest_levels(R)

        # replica deployment: a connected RGG over the unit square
        graph = None
        for attempt in range(32):
            g = random_geometric_graph(R, seed=seed + 1000 * attempt)
            if g.is_connected():
                graph = g
                break
        if graph is None:
            raise RuntimeError(f"no connected RGG deployment for R={R}")
        self.graph = graph
        try:
            self.plan = build_plan(graph, k=len(self.levels), seed=seed)
        except Exception:
            # tiny fleets where the suggest_levels depth over-partitions
            # the geometric deployment fall back to the plan's own rule
            self.plan = build_plan(graph, seed=seed)

        self.rounds_run = 0
        self.total_messages = 0
        self.total_bytes = 0

    @property
    def payload_values(self) -> int:
        return len(LOAD_FIELDS) + (self.R if self.full_view else 0)

    def round(self, loads: np.ndarray, scores: Optional[np.ndarray] = None,
              round_idx: Optional[int] = None) -> RoundResult:
        """One multiscale control round.

        loads: (R, F) local load vectors, F == len(LOAD_FIELDS).
        scores: (R,) scalar routing loads (required when full_view).
        round_idx: drives the round's exchange randomness (defaults to
            the internal round counter) — one seed per round, shared by
            every payload field.
        """
        loads = np.asarray(loads, np.float64)
        if loads.shape != (self.R, len(LOAD_FIELDS)):
            raise ValueError(
                f"loads must be ({self.R}, {len(LOAD_FIELDS)}), "
                f"got {loads.shape}"
            )
        fields = [loads[:, f] for f in range(loads.shape[1])]
        if self.full_view:
            if scores is None:
                raise ValueError("full_view=True needs per-replica scores")
            scores = np.asarray(scores, np.float64).ravel()
            # field F+j holds R * score_j at replica j (mean == score_j):
            # the rows of one scaled identity, the same products as the
            # reference's R identities, one row each
            fields.extend(np.eye(self.R) * (self.R * scores)[:, None])
        x0 = np.stack(fields).astype(np.float32)          # (T, R)
        if round_idx is None:
            round_idx = self.rounds_run
        # ONE presampled schedule for the whole payload: every field
        # rides the same exchanges (same seed -> same schedule), i.e. a
        # single packet per exchange carries payload_values floats
        seed = self.seed * 7_919 + int(round_idx)
        T = x0.shape[0]
        # weighted ratio-consensus: unequal cell sizes otherwise bias the
        # promoted averages (spiky table fields are the worst case)
        res = execute_plan(
            self.plan, x0, eps=self.eps, seeds=[seed] * T,
            fixed_ticks_scale=self.fixed_ticks_scale, weighted=True,
            options=self.options,
        )
        messages = int(res.messages[0])
        assert int(res.messages.min()) == int(res.messages.max()), (
            "payload fields must share one exchange schedule"
        )
        nbytes = messages * self.payload_values * self.bytes_per_value

        F = len(LOAD_FIELDS)
        summary = np.asarray(res.x_final[:F]).T            # (R, F)
        table = (
            np.asarray(res.x_final[F:]).T if self.full_view else None
        )                                                  # (R, R)
        self.rounds_run += 1
        self.total_messages += messages
        self.total_bytes += nbytes
        return RoundResult(
            summary=summary,
            table=table,
            messages=messages,
            control_bytes=nbytes,
            level_messages=np.asarray(res.level_messages[0], np.int64),
            level_ticks=np.asarray(res.level_ticks[0], np.int64),
            payload_values=self.payload_values,
        )
