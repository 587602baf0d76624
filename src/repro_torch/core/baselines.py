"""Baselines the paper compares against (§II, §VI).

* `path_averaging`  — Benezit et al. [13]: route to a random target,
  average ALL nodes along the path (the state of the art the paper
  benchmarks against in Fig. 3/5).
* `geographic_gossip` — Dimakis et al. [11]: route to a random target,
  pairwise-average with the recipient only.
* `standard_gossip` — Boyd et al. [2]: single-hop neighbor gossip
  (wraps the batched engine with B=1).

Both routing-heavy baselines draw their routes through the same
vectorized router the plan/execute core uses
(`routing.batched_greedy_routes`): routes for a large block of upcoming
iterations are computed in one batched frontier-stepping call, consumed
in convergence-check windows, and send attribution is a vectorized
scatter-add over the padded path arrays
(`routing.accumulate_route_sends`) instead of per-hop Python loops.
Only the value updates remain sequential (they are order-dependent);
they are O(path length) numpy ops per iteration.

The (source, target) stream is drawn in the same per-iteration order as
the historical scalar implementation, and routing is value- and
rng-free, so in the reliable regime the trajectory, message count, and
attribution are draw-for-draw identical to the pre-batching code.

All report total single-hop transmissions and per-node send counts so
the paper's figures can be reproduced exactly.  `path_averaging` and
`geographic_gossip` run on the host in numpy, draw for draw as the
reference; `standard_gossip` runs the port's `gossip_until`, on the card
by default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .gossip import gossip_until
from .rgg import Graph
from .routing import accumulate_route_sends, batched_greedy_routes

_ROUTE_BLOCK = 512  # iterations routed per batched router call

__all__ = [
    "BaselineResult",
    "path_averaging",
    "geographic_gossip",
    "standard_gossip",
]


@dataclasses.dataclass
class BaselineResult:
    x: np.ndarray            # (n,) final estimates
    messages: int            # total single-hop transmissions
    iterations: int
    converged: bool
    node_sends: np.ndarray   # (n,)

    def error(self, x0: np.ndarray) -> float:
        avg = float(np.mean(x0))
        return float(np.linalg.norm(self.x - avg) / np.linalg.norm(x0))


def _block_routes(g: Graph, rng: np.random.Generator, count: int):
    """Draw `count` (source, random-target) requests — in the exact
    per-iteration order of the scalar reference, so trajectories are
    reproducible draw-for-draw — and route them in one batched call."""
    srcs = np.empty(count, np.int64)
    targets = np.empty((count, 2))
    for i in range(count):
        srcs[i] = rng.integers(g.n)
        targets[i] = rng.uniform(0.0, 1.0, 2)
    return srcs, batched_greedy_routes(g, srcs, targets)


def path_averaging(
    g: Graph,
    x0: np.ndarray,
    *,
    eps: float = 1e-4,
    seed: int = 0,
    max_iters: int = 2_000_000,
    check_every: int = 32,
    loss_p: Optional[float] = None,
) -> BaselineResult:
    """Randomized path averaging [13].

    One iteration: a uniformly random node wakes, draws a uniform target
    location, greedy-routes toward it accumulating values (|S|-1
    messages), the recipient averages and sends the result back down the
    path (|S|-1 messages), and every path node adopts the average.

    With `loss_p`, every single-hop transmission independently succeeds
    w.p. loss_p; a lost forward message aborts the iteration, a lost
    reply strands the prefix of the path with stale values (mass is
    distorted — paper §VI-C-2).
    """
    rng = np.random.default_rng(seed)
    n = g.n
    x = np.asarray(x0, np.float64).copy()
    mean = float(np.mean(x0))
    tol = eps * float(np.linalg.norm(x0))
    node_sends = np.zeros(n, np.int64)
    messages = 0
    it = 0
    converged = False
    while it < max_iters and not converged:
        # a block is a whole number of convergence windows so checks land
        # on the same global iteration counts as the scalar reference
        # (which, like this loop, may overshoot max_iters by < check_every)
        windows_left = -(-(max_iters - it) // check_every)
        block = check_every * max(1, min(_ROUTE_BLOCK // check_every, windows_left))
        _, routes = _block_routes(g, rng, block)
        nodes, hops = routes.nodes, routes.hops
        for w0 in range(0, block, check_every):
            w1 = w0 + check_every
            it += check_every
            if loss_p is None:
                messages += int(2 * hops[w0:w1].sum())
                accumulate_route_sends(
                    node_sends, nodes[w0:w1], hops[w0:w1]
                )
                for r in range(w0, w1):
                    L = int(hops[r])
                    if L == 0:
                        continue  # degenerate: src already closest to target
                    p = nodes[r, : L + 1]
                    x[p] = x[p].mean()
            else:
                fwd_fail = rng.geometric(1.0 - loss_p, size=w1 - w0)
                rep_fail = rng.geometric(1.0 - loss_p, size=w1 - w0)
                for r in range(w0, w1):
                    L = int(hops[r])
                    if L == 0:
                        continue
                    p = nodes[r, : L + 1]
                    # forward pass: hop t = p[t-1] -> p[t]
                    if fwd_fail[r - w0] <= L:
                        f = int(fwd_fail[r - w0])
                        messages += f
                        node_sends[p[:f]] += 1
                        continue
                    messages += L
                    node_sends[p[:-1]] += 1
                    avg = float(x[p].mean())
                    # reply pass: hop t = p[L-t+1] -> p[L-t]
                    upd = int(min(rep_fail[r - w0], L))
                    messages += upd
                    node_sends[p[L : L - upd : -1]] += 1
                    x[p[L - upd + 1 :]] = avg  # recipient + delivered prefix
            if np.linalg.norm(x - mean) <= tol:
                converged = True
                break
    return BaselineResult(
        x=x, messages=messages, iterations=it, converged=converged,
        node_sends=node_sends,
    )


def geographic_gossip(
    g: Graph,
    x0: np.ndarray,
    *,
    eps: float = 1e-4,
    seed: int = 0,
    max_iters: int = 5_000_000,
    check_every: int = 64,
) -> BaselineResult:
    """Geographic gossip [11]: pairwise averaging with the node closest
    to a random target location, 2*hops messages per iteration."""
    rng = np.random.default_rng(seed)
    n = g.n
    x = np.asarray(x0, np.float64).copy()
    mean = float(np.mean(x0))
    tol = eps * float(np.linalg.norm(x0))
    node_sends = np.zeros(n, np.int64)
    messages = 0
    it = 0
    converged = False
    while it < max_iters and not converged:
        windows_left = -(-(max_iters - it) // check_every)
        block = check_every * max(1, min(_ROUTE_BLOCK // check_every, windows_left))
        srcs, routes = _block_routes(g, rng, block)
        nodes, hops = routes.nodes, routes.hops
        dsts = nodes[np.arange(block), hops]
        for w0 in range(0, block, check_every):
            w1 = w0 + check_every
            it += check_every
            messages += int(2 * hops[w0:w1].sum())
            accumulate_route_sends(node_sends, nodes[w0:w1], hops[w0:w1])
            for r in range(w0, w1):
                if hops[r] == 0:
                    continue
                avg = 0.5 * (x[srcs[r]] + x[dsts[r]])
                x[srcs[r]] = avg
                x[dsts[r]] = avg
            if np.linalg.norm(x - mean) <= tol:
                converged = True
                break
    return BaselineResult(
        x=x, messages=messages, iterations=it, converged=converged,
        node_sends=node_sends,
    )


def standard_gossip(
    g: Graph,
    x0: np.ndarray,
    *,
    eps: float = 1e-4,
    seed: int = 0,
    max_ticks: int = 50_000_000,
    backend: str = "cuda",
    device: str = "cuda",
) -> BaselineResult:
    """Single-hop randomized gossip [2] via the batched engine (B=1).

    `backend` and `device` are `gossip_until`'s: on the card each chunk
    is one `sample_chunk` and one `pair_apply` launch."""
    res = gossip_until(
        np.asarray(x0, np.float32)[None, :],
        g.neighbors[None],
        g.degrees[None],
        np.array([g.n], np.int32),
        eps=eps,
        seed=seed,
        max_ticks=max_ticks,
        backend=backend,
        device=device,
    )
    usage = res.edge_usage[0]
    node_sends = usage.sum(axis=1).astype(np.int64)
    valid = g.neighbors >= 0
    np.add.at(node_sends, g.neighbors[valid], usage[valid])
    return BaselineResult(
        x=res.estimates()[0, : g.n],
        messages=res.total_messages,
        iterations=int(res.ticks[0]),
        converged=bool(res.converged[0]),
        node_sends=node_sends,
    )
