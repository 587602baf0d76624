"""Wireless-medium failure and cost models: the declarative surfaces
threaded through `multiscale_gossip` → `execute_plan`.

* `FailureModel` — `loss_p` is the paper's §VI-C-2 message-loss model
  (a lost request aborts the exchange, a lost reply leaves only the
  contacted node updated), drawn inside the exchange schedule.  The
  scenario fields (churn, stragglers, regional outage, Byzantine
  dropped updates) perturb the presampled schedule in the reference;
  the port's engine does not run them yet and raises
  `NotImplementedError`.
* `CostModel` — per-hop energy, Geometric link-level retransmissions
  and a congestion surcharge, priced from the schedule in the
  reference; not ported yet either (the engine raises).

Both dataclasses are frozen and validated exactly as the reference's.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CostModel", "FailureModel"]


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
