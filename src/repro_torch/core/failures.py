"""Transmission-failure models (paper §VI-C).

* Handshake model: every single-hop transmission independently succeeds
  w.p. p, and link-level ACK/retransmission repeats it until delivery.
  The algorithm trajectory is UNCHANGED — only the cost inflates: each
  logical transmission costs Geometric(p) physical ones.  Sampled
  exactly as T + NegBinomial(T, p) (sum of T iid geometrics).

* Message-loss model: a transmission failing means the message is gone.
  This changes the trajectory and destroys mass; it is implemented
  inside the gossip engine (`FailureModel(loss_p=...)`) and path
  averaging (`loss_p=`), per §VI-C-2.

There is ONE pricing path: `core.medium.price_messages` /
`CostModel(retransmit_p=...)`, which price per trial and per level
(and, threaded through `execute_plan`, directly on the presampled
schedule with congestion and hop-distance awareness).  `handshake_cost`
survives only as a thin scalar wrapper over it, preserving the
historical API (same validation, same seeded draws) for old callers.
"""
from __future__ import annotations

import numpy as np

__all__ = ["handshake_cost"]


def handshake_cost(
    transmissions: int, p: float, rng: np.random.Generator | None = None
) -> int:
    """Physical transmissions needed to deliver `transmissions` messages
    when each attempt succeeds w.p. p with retransmission until success.

    Thin wrapper over `core.medium.price_messages` (the single pricing
    path): the handshake total ``T + NegBinomial(T, p)`` is exactly its
    ``physical_transmissions``.  Bitwise-compatible with the historical
    scalar implementation — identical validation message, identical
    draws for a given rng (one NegBinomial(T, p) variate), and the
    historical fixed-seed default ``default_rng(0)`` when no rng is
    passed (`price_messages` itself refuses a hidden default; the
    legacy scalar API keeps it for reproducibility of old scripts).
    """
    from .medium import CostModel, price_messages

    if not 0.0 < p <= 1.0:
        raise ValueError(f"success probability must be in (0, 1], got {p}")
    if p == 1.0 or transmissions == 0:
        return int(transmissions)
    cost = price_messages(
        int(transmissions),
        CostModel(retransmit_p=p),
        rng=rng or np.random.default_rng(0),
    )
    return int(cost.physical_transmissions[0])
