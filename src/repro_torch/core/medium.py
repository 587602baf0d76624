"""Wireless-medium transmission-cost and failure models.

The paper's systems argument is that multiscale gossip wins *on the
wireless medium* — link-level ACKs, retransmissions and congestion —
not just on raw message counts (§VI-C).  This module prices the
presampled exchange schedule and describes the failures injected into
it:

* `CostModel` — per-hop energy, iid-Geometric(p) link-level
  retransmissions, and a congestion surcharge for concurrent exchanges
  sharing the medium.  Pricing is a reduction over each presampled
  ``(T, B)`` chunk (`kernels.sample_chunk` draws it and counts its
  retransmissions and concurrency in the same launch); the
  retransmission draws come from a tagged stream disjoint from the
  exchange stream, so turning the cost model on never perturbs the
  exchange trajectory.  `EngineResult.cost` carries the priced result.
* `FailureModel` — `loss_p` is the paper's §VI-C-2 message-loss model;
  the scenario fields (churn, stragglers, regional outage, Byzantine
  dropped updates) perturb the presampled schedule, so a scenario run is
  the reliable run's schedule with events injected.  Event times are
  fractions of the finest level's tick budget (fixed-iterations mode).
* `FailureCtx` — one level's failure flags on the device, packed into
  one ``(B, C)`` uint8 bit field, plus the level's event windows.
* Host-side pricing without a schedule: `price_messages` (baselines),
  `route_edge_transmissions` / `level_edge_messages` /
  `price_edge_messages` (closed-form per-edge pricing) and
  `failure_sets` (the host draw of the failure node sets).

Both dataclasses are frozen, hashable and validated exactly as the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "CostModel",
    "FailureModel",
    "MediumCost",
    "FailureCtx",
    "expected_retransmissions",
    "price_messages",
    "failure_sets",
    "route_edge_transmissions",
    "level_edge_messages",
    "price_edge_messages",
]

# RNG stream tags for cost/perturbation draws: folded into the level key
# BEFORE the per-chunk fold, so these streams are disjoint from the
# exchange streams (fold_in(key, t)) by construction — extra draws from
# them cannot perturb any exchange decision.
_TAG_RETX = 2_147_483_640
_TAG_STRAGGLER = 2_147_483_641

@dataclasses.dataclass(frozen=True)
class CostModel:
    """Wireless transmission pricing (static, hashable).

    hop_energy: energy units per physical single-hop transmission — a
        scalar, or a per-overlay-edge tuple keyed off one level's
        route-incidence CSR (heterogeneous links: long hops cost more).
        Per-edge models are priced closed-form only, through
        `level_edge_messages` + `price_edge_messages`; the schedule
        reduction and `price_messages` reject them.
    retransmit_p: per-attempt link-level delivery probability; each
        logical single-hop transmission physically takes Geometric(p)
        attempts (ACK/retransmit until delivery, the handshake model of
        §VI-C-1).  1.0 disables retransmissions.
    congestion_alpha: energy surcharge, per active exchange and per
        OTHER exchange concurrent with it at the same tick of the same
        level (the level's cells share the radio medium) — the
        surcharge for one exchange at a tick with c concurrent
        exchanges is ``hop_energy * congestion_alpha * (c - 1)``.
    sample: True samples the Geometric retransmissions inside the
        schedule reduction (independent RNG stream, bitwise-neutral);
        False prices them with the closed-form mean ``T * (1-p)/p``.
    """

    hop_energy: object = 1.0  # float | per-edge tuple[float, ...]
    retransmit_p: float = 1.0
    congestion_alpha: float = 0.0
    sample: bool = True

    def __post_init__(self):
        if not 0.0 < self.retransmit_p <= 1.0:
            raise ValueError(
                f"retransmit_p must be in (0, 1], got {self.retransmit_p}")
        he = self.hop_energy
        if not isinstance(he, (int, float)):
            # a list/ndarray (natural from configs) would silently break
            # hashability — coerce to a tuple, like regional_window
            try:
                he = tuple(float(v) for v in he)
            except (TypeError, ValueError):
                raise ValueError(
                    f"hop_energy must be a float or a per-edge sequence "
                    f"of floats, got {self.hop_energy!r}")
            object.__setattr__(self, "hop_energy", he)
            if any(v < 0 for v in he):
                raise ValueError("hop_energy / congestion_alpha must be >= 0")
        elif he < 0:
            raise ValueError("hop_energy / congestion_alpha must be >= 0")
        if self.congestion_alpha < 0:
            raise ValueError("hop_energy / congestion_alpha must be >= 0")

    @property
    def heterogeneous(self) -> bool:
        """True when hop_energy is a per-edge map (closed-form pricing
        through `price_edge_messages` only)."""
        return isinstance(self.hop_energy, tuple)


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Failure/churn surface (static, hashable).

    loss_p: per-hop message delivery probability (paper §VI-C-2; a lost
        request aborts the exchange, a lost reply leaves only the
        contacted node updated).  None = reliable.  Bitwise-identical
        to the legacy ``loss_p=`` kwarg.  May also be a per-overlay-edge
        tuple keyed off one level's route-incidence CSR (heterogeneous
        links) — per-edge models price closed-form only, through
        `level_edge_messages` + `price_edge_messages`; the trajectory
        engine rejects them.
    churn_fraction / churn_time: `churn_fraction` of the nodes leave
        the network at `churn_time` (fraction of the finest level's
        tick budget) and stay down for the rest of the run — their
        exchanges vanish; a live node contacting a churned partner
        wastes the forward-leg transmissions.
    straggler_fraction / straggler_success: stragglers' exchanges
        succeed only w.p. `straggler_success` per attempt (slow or
        heterogeneous links); failed attempts are still priced at full
        exchange cost (the link stalls, the radios transmitted).
    regional_radius / regional_window: nodes within `regional_radius`
        of a random epicenter are down during
        ``[window[0], window[1])`` (fractions of the finest level's
        budget) — a correlated regional outage.  ``window[1] > 1``
        makes the outage permanent (persists through coarser levels).
    drop_fraction: Byzantine/dropped updates — the flagged nodes never
        apply incoming updates (their stale value keeps leaking into
        the average, the paper's mass-distortion failure).  The
        mass-weighted variant (``weighted=True``) is the EF-style
        recovery story: values travel as (w·x, w) pairs, so a frozen
        node distorts the fused mean by at most its own share.
    seed: failure-injection RNG (node selection, epicenter draw) —
        independent of the gossip seed.
    """

    loss_p: object = None  # None | float | per-edge tuple[float, ...]
    churn_fraction: float = 0.0
    churn_time: float = 0.5
    straggler_fraction: float = 0.0
    straggler_success: float = 0.25
    regional_radius: float = 0.0
    regional_window: tuple = (0.25, 0.75)
    drop_fraction: float = 0.0
    seed: int = 0

    def __post_init__(self):
        lp = self.loss_p
        if lp is not None and not isinstance(lp, (int, float)):
            # per-edge map: coerce to a tuple (hashability, as with
            # regional_window) and validate every entry
            try:
                lp = tuple(float(v) for v in lp)
            except (TypeError, ValueError):
                raise ValueError(
                    f"loss_p must be None, a float, or a per-edge "
                    f"sequence of floats, got {self.loss_p!r}")
            object.__setattr__(self, "loss_p", lp)
            for v in lp:
                if not 0.0 < v <= 1.0:
                    raise ValueError(f"loss_p must be in (0, 1], got {v}")
        elif lp is not None and not 0.0 < lp <= 1.0:
            raise ValueError(f"loss_p must be in (0, 1], got {lp}")
        for name in ("churn_fraction", "straggler_fraction", "drop_fraction"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if not 0.0 < self.straggler_success <= 1.0:
            raise ValueError("straggler_success must be in (0, 1]")
        # a list (natural from JSON configs) would silently break the
        # frozen dataclass's hashability, which the compiled-executor
        # cache key relies on — coerce and validate
        try:
            w = tuple(float(t) for t in self.regional_window)
        except (TypeError, ValueError):
            raise ValueError(
                f"regional_window must be a (t0, t1) pair of floats, "
                f"got {self.regional_window!r}")
        if len(w) != 2:
            raise ValueError(
                f"regional_window must be a (t0, t1) pair, got {w!r}")
        if not 0.0 <= w[0] <= w[1]:
            raise ValueError(
                f"regional_window needs 0 <= t0 <= t1, got {w!r}")
        object.__setattr__(self, "regional_window", w)

    @property
    def heterogeneous(self) -> bool:
        """True when loss_p is a per-edge map (closed-form pricing
        through `price_edge_messages` only)."""
        return isinstance(self.loss_p, tuple)

    @property
    def has_scenario(self) -> bool:
        """True when any schedule-perturbing field is active (loss_p
        alone is the legacy trajectory-level model, not a scenario)."""
        return (
            self.churn_fraction > 0
            or self.straggler_fraction > 0
            or self.regional_radius > 0
            or self.drop_fraction > 0
        )


# FailureCtx.bits: one bit a failure flag of a slot
CHURNED, STRAGGLER, BYZ, REGIONAL = 1, 2, 4, 8


class FailureCtx(NamedTuple):
    """One level's scenario flags on the device plus its event windows.

    Built by the engine from `failure_sets` mapped through the level's
    `slot_node`; consumed by the chunk draw (`kernels.sample_chunk`).
    The four ``(B, C)`` flags of the reference (churned, straggler, byz,
    regional) are packed into `bits`, as the kernel reads them; the
    properties unpack them.
    """

    bits: torch.Tensor   # (B, C) uint8: CHURNED | STRAGGLER | BYZ | REGIONAL
    churn_tick: int      # level-local tick from which churned slots are down
    reg_t0: int          # regional slots are down during [reg_t0, reg_t1)
    reg_t1: int
    straggler_success: float  # 1.0: no straggler stream is drawn

    @classmethod
    def from_masks(cls, churned, straggler, byz, regional, churn_tick: int,
                   reg_t0: int, reg_t1: int, straggler_success: float,
                   device=None) -> "FailureCtx":
        """Pack four (B, C) bool numpy masks into `bits` on `device`."""
        bits = (np.asarray(churned, np.uint8) * CHURNED
                | np.asarray(straggler, np.uint8) * STRAGGLER
                | np.asarray(byz, np.uint8) * BYZ
                | np.asarray(regional, np.uint8) * REGIONAL)
        return cls(torch.as_tensor(bits.astype(np.uint8), device=device),
                   int(churn_tick), int(reg_t0), int(reg_t1),
                   float(straggler_success))

    def flag(self, bit: int) -> torch.Tensor:
        return (self.bits & bit) != 0

    @property
    def churned(self) -> torch.Tensor:
        return self.flag(CHURNED)

    @property
    def straggler(self) -> torch.Tensor:
        return self.flag(STRAGGLER)

    @property
    def byz(self) -> torch.Tensor:
        return self.flag(BYZ)

    @property
    def regional(self) -> torch.Tensor:
        return self.flag(REGIONAL)


@dataclasses.dataclass
class MediumCost:
    """Per-trial priced cost of one plan execution (T trials).

    All arrays are host-side float64; `transmissions` equals the
    engine's logical message count (single-hop transmissions including
    the dissemination down-pass) — pricing never changes it.
    """

    transmissions: np.ndarray      # (T,) logical single-hop transmissions
    retransmissions: np.ndarray    # (T,) extra physical attempts
    congestion: np.ndarray         # (T,) concurrency surcharge, energy units
    energy: np.ndarray             # (T,) total energy
    level_energy: np.ndarray       # (T, L) per executed level (no down-pass)
    model: CostModel

    @property
    def physical_transmissions(self) -> np.ndarray:
        return self.transmissions + self.retransmissions


def expected_retransmissions(transmissions, p: float) -> np.ndarray:
    """Closed-form mean extra attempts for `transmissions` logical
    single-hop transmissions: each takes Geometric(p) physical attempts
    (mean 1/p), so the extra attempts sum to ``T * (1 - p) / p``."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"retransmit_p must be in (0, 1], got {p}")
    return np.asarray(transmissions, np.float64) * (1.0 - p) / p


def price_messages(
    messages,
    model: CostModel,
    rng: Optional[np.random.Generator] = None,
) -> MediumCost:
    """Price a plain message count (scalar or per-trial array) without a
    schedule — the host-side path for baselines (e.g. path averaging)
    whose executors do not run the presampled reduction.  Congestion is
    0 (no concurrency information in a bare count).

    Supersedes `core.failures.handshake_cost`: the handshake total
    ``T + NegBinomial(T, p)`` is exactly `transmissions +
    retransmissions` here.

    When ``model.sample`` and retransmissions are in play
    (``retransmit_p < 1``), `rng` is required: a hidden fixed-seed
    default would make every no-rng call draw identical NegBinomial
    variates, so repeated "sampled" pricings of different runs would
    be silently correlated.
    """
    if model.heterogeneous:
        raise ValueError(
            "per-edge hop_energy has no meaning for a bare message count "
            "— use level_edge_messages + price_edge_messages")
    msgs = np.atleast_1d(np.asarray(messages, np.int64))
    p = model.retransmit_p
    if p >= 1.0:
        retx = np.zeros(msgs.shape, np.float64)
    elif model.sample:
        if rng is None:
            raise ValueError(
                "price_messages needs an explicit rng when model.sample "
                "and retransmit_p < 1 (pass sample=False for the "
                "closed-form mean instead)")
        retx = np.array(
            [float(rng.negative_binomial(int(m), p)) if m > 0 else 0.0
             for m in msgs])
    else:
        retx = expected_retransmissions(msgs, p)
    cong = np.zeros(msgs.shape, np.float64)
    energy = model.hop_energy * (msgs + retx)
    return MediumCost(
        transmissions=msgs.astype(np.float64), retransmissions=retx,
        congestion=cong, energy=energy,
        level_energy=energy[:, None], model=model,
    )


def route_edge_transmissions(lp) -> np.ndarray:
    """Per-overlay-edge single-hop transmissions of ONE request+reply
    exchange over that edge: the sum of the level's route-incidence
    counts attributed to the edge (path endpoints transmit once,
    interior relays twice — i.e. ``2 * route_hops``).

    `lp` is a level plan carrying the overlay attribution arrays
    (`edge_pos_i` / `inc_edge` / `inc_count`); levels without routed
    overlay exchanges (finest level, cell-local gossip) are rejected.
    """
    if lp.edge_pos_i is None or lp.inc_edge is None:
        raise ValueError(
            "level has no overlay route-incidence attribution "
            "(per-edge pricing applies to routed overlay levels only)")
    tx = np.zeros(len(np.asarray(lp.edge_pos_i)), np.int64)
    np.add.at(tx, np.asarray(lp.inc_edge, np.int64),
              np.asarray(lp.inc_count, np.int64))
    return tx


def level_edge_messages(lp, usage) -> np.ndarray:
    """Per-overlay-edge logical single-hop transmissions of one level
    run: the edge's exchange count — its two directed usage counters,
    gathered from the flat `usage` buffer exactly as `overlay_node_sends`
    does — times its per-exchange route transmissions.  `usage` may be
    ``(U,)`` or carry leading trial axes (``(T, U)``); the edge axis is
    appended last.
    """
    tx = route_edge_transmissions(lp)
    usage = np.asarray(usage, np.int64)
    use_e = usage[..., lp.edge_pos_i] + usage[..., lp.edge_pos_j]
    return use_e * tx


def price_edge_messages(
    edge_messages,
    model: CostModel,
    failures: Optional[FailureModel] = None,
) -> MediumCost:
    """Closed-form pricing of per-edge logical transmission counts under
    heterogeneous links: `model.hop_energy` and `failures.loss_p` may
    each be a per-edge tuple (or a scalar, broadcast over edges).

    The per-attempt delivery probability of edge e is
    ``p_e = retransmit_p * loss_p_e`` (link-level ACK loss compounds
    with medium loss); expected extra attempts are the Geometric mean
    ``m_e * (1 - p_e) / p_e`` and energy is
    ``hop_energy_e * (m_e + retx_e)``.  Closed-form ONLY: per-edge
    sampling has no schedule to draw against, so a sampling model
    (``model.sample`` with an effective ``p_e < 1``) is rejected —
    construct the model with ``sample=False``.

    `edge_messages` is ``(E,)`` or ``(T, E)`` (from
    `level_edge_messages`); returns a `MediumCost` whose per-trial
    totals sum over edges and whose `level_energy` is the per-edge
    energy breakdown ``(T, E)``.  Congestion is 0 (no concurrency
    information in per-edge counts).
    """
    msgs = np.asarray(edge_messages, np.float64)
    if msgs.ndim == 1:
        msgs = msgs[None, :]
    elif msgs.ndim != 2:
        raise ValueError(
            f"edge_messages must be (E,) or (T, E), got shape {msgs.shape}")
    E = msgs.shape[1]

    def per_edge(v, name):
        if isinstance(v, tuple):
            if len(v) != E:
                raise ValueError(
                    f"{name} has {len(v)} entries but edge_messages has "
                    f"{E} edges")
            return np.asarray(v, np.float64)
        return np.full(E, float(v), np.float64)

    hop_e = per_edge(model.hop_energy, "hop_energy")
    loss = failures.loss_p if failures is not None else None
    loss_e = per_edge(loss if loss is not None else 1.0, "loss_p")
    p_e = model.retransmit_p * loss_e
    if model.sample and np.any(p_e < 1.0):
        raise ValueError(
            "per-edge pricing is closed-form only — pass "
            "CostModel(sample=False) (there is no schedule to sample "
            "per-edge retransmissions against)")
    retx_e = msgs * (1.0 - p_e) / p_e
    edge_energy = hop_e * (msgs + retx_e)
    return MediumCost(
        transmissions=msgs.sum(axis=1),
        retransmissions=retx_e.sum(axis=1),
        congestion=np.zeros(msgs.shape[0], np.float64),
        energy=edge_energy.sum(axis=1),
        level_energy=edge_energy,
        model=model,
    )


def failure_sets(model: FailureModel, n: int, coords=None) -> dict:
    """Draw the failure-injection node sets (host, deterministic in
    `model.seed`): boolean (n,) masks for churned / straggler / byz /
    regional nodes, plus the regional epicenter.  The draw order is
    fixed so adding one scenario field never reshuffles another's set.
    """
    rng = np.random.default_rng(model.seed)

    def pick(frac):
        m = np.zeros(n, bool)
        k = int(round(frac * n))
        if k > 0:
            m[rng.choice(n, size=min(k, n), replace=False)] = True
        return m

    churned = pick(model.churn_fraction)
    straggler = pick(model.straggler_fraction)
    byz = pick(model.drop_fraction)
    epicenter = rng.uniform(0.0, 1.0, 2)
    regional = np.zeros(n, bool)
    if model.regional_radius > 0 and coords is not None:
        d = np.linalg.norm(np.asarray(coords) - epicenter[None, :], axis=1)
        regional = d < model.regional_radius
    return {
        "churned": churned, "straggler": straggler, "byz": byz,
        "regional": regional, "epicenter": epicenter,
    }
