"""Greedy geographic routing (paper §II, Dimakis et al. [11]).

A message addressed to a target (x, y) location is forwarded, at each
hop, to the neighbor closest to the target; the node closer to the
target than all of its neighbors is the final recipient.  For RGGs with
the connectivity radius this succeeds w.h.p.; as an engineering fallback
(finite n), a stuck route that has not reached the intended node is
completed with a BFS shortest path and flagged.

Two router implementations share the same semantics:

* scalar (`greedy_route` / `route_to_node`) — one walk at a time, the
  reference implementation;
* batched (`batched_greedy_routes` / `batched_routes_to_nodes`) —
  vectorized frontier stepping over E routes at once (all overlay edges
  of a hierarchy level in one call), with a batched level-synchronous
  BFS fallback that reproduces the scalar FIFO BFS hop-for-hop.  The
  batched form returns padded `(E, L+1)` path arrays, the format the
  plan/execute simulation core (`core.plan` / `core.engine`) consumes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from .rgg import Graph

__all__ = [
    "Route",
    "BatchedRoutes",
    "greedy_route",
    "route_to_node",
    "route_table",
    "batched_greedy_routes",
    "batched_routes_to_nodes",
    "accumulate_route_sends",
]


@dataclasses.dataclass(frozen=True)
class Route:
    nodes: np.ndarray   # node ids along the path, nodes[0] = source
    hops: int           # len(nodes) - 1
    greedy_ok: bool     # False if BFS fallback was needed

    def send_counts(self, n: int) -> np.ndarray:
        """Per-node single-hop sends for one request+reply exchange.

        Forward pass: nodes[0..L-1] each transmit once; reply pass:
        nodes[L..1] each transmit once (2L transmissions total).
        """
        sends = np.zeros(n, np.int64)
        if self.hops > 0:
            np.add.at(sends, self.nodes[:-1], 1)
            np.add.at(sends, self.nodes[1:], 1)
        return sends


def greedy_route(
    g: Graph, src: int, target_xy: np.ndarray, max_hops: Optional[int] = None
) -> Route:
    """Route from `src` toward the point `target_xy`; returns the path to
    the node that is locally closest to the target."""
    if max_hops is None:
        max_hops = 4 * g.n
    coords = g.coords
    path = [int(src)]
    cur = int(src)
    d_cur = float(np.sum((coords[cur] - target_xy) ** 2))
    for _ in range(max_hops):
        deg = g.degrees[cur]
        if deg == 0:
            break
        s = g.nbr_start[cur]
        nbrs = g.nbr_flat[s:s + deg]
        d = np.sum((coords[nbrs] - target_xy) ** 2, axis=1)
        best = int(np.argmin(d))
        if d[best] >= d_cur:
            break  # cur is the local minimizer: final recipient
        cur = int(nbrs[best])
        d_cur = float(d[best])
        path.append(cur)
    return Route(nodes=np.asarray(path, np.int32), hops=len(path) - 1, greedy_ok=True)


def route_to_node(g: Graph, src: int, dst: int) -> Route:
    """Greedy-route from src to the location of dst; BFS fallback if the
    greedy walk terminates elsewhere (rare on connected RGGs)."""
    r = greedy_route(g, src, g.coords[dst])
    if int(r.nodes[-1]) == int(dst):
        return r
    bfs = _bfs_path(g, src, dst)
    if bfs is None:  # disconnected: report the greedy attempt
        return Route(nodes=r.nodes, hops=r.hops, greedy_ok=False)
    return Route(nodes=bfs, hops=len(bfs) - 1, greedy_ok=False)


def _bfs_path(g: Graph, src: int, dst: int) -> Optional[np.ndarray]:
    prev = np.full(g.n, -1, np.int64)
    prev[src] = src
    q = deque([int(src)])
    while q:
        u = q.popleft()
        if u == dst:
            break
        for v in g.nbr_flat[g.nbr_start[u]:g.nbr_start[u] + g.degrees[u]]:
            v = int(v)
            if prev[v] < 0:
                prev[v] = u
                q.append(v)
    if prev[dst] < 0:
        return None
    path = [int(dst)]
    while path[-1] != src:
        path.append(int(prev[path[-1]]))
    return np.asarray(path[::-1], np.int32)


def route_table(g: Graph, pairs: np.ndarray) -> list[Route]:
    """Routes for each (u, v) pair (used to precompute overlay-edge costs)."""
    return [route_to_node(g, int(u), int(v)) for u, v in pairs]


# ---------------------------------------------------------------------------
# Batched routing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchedRoutes:
    """E routes as padded arrays: nodes[e, 0] is the source, nodes[e, t]
    the node after t hops, -1 past the end."""

    nodes: np.ndarray      # (E, Lmax + 1) int32, padded with -1
    hops: np.ndarray       # (E,) int32
    greedy_ok: np.ndarray  # (E,) bool — False where the BFS fallback ran

    def __len__(self) -> int:
        return int(self.nodes.shape[0])

    def route(self, e: int) -> Route:
        L = int(self.hops[e])
        return Route(
            nodes=self.nodes[e, : L + 1].astype(np.int32),
            hops=L,
            greedy_ok=bool(self.greedy_ok[e]),
        )


def batched_greedy_routes(
    g: Graph,
    srcs: np.ndarray,
    targets_xy: np.ndarray,
    max_hops: Optional[int] = None,
) -> BatchedRoutes:
    """Greedy-route E sources toward E target locations simultaneously.

    Vectorized frontier stepping: one numpy step advances every live
    route by one hop.  Semantics (tie-breaking included) match
    `greedy_route` exactly: rows of `g.neighbors` are compact, so the
    argmin over the padded row with +inf on padding picks the same slot
    the scalar argmin over the first `deg` entries does.
    """
    E = len(srcs)
    if max_hops is None:
        max_hops = 4 * g.n
    cx, cy = g.coords[:, 0], g.coords[:, 1]
    cur = np.asarray(srcs, np.int64).copy()
    targets = np.asarray(targets_xy, np.float64).reshape(E, 2)
    tx, ty = targets[:, 0], targets[:, 1]
    d_cur = (cx[cur] - tx) ** 2 + (cy[cur] - ty) ** 2
    hops = np.zeros(E, np.int64)
    cols = [cur.astype(np.int32)]
    # the frontier compresses to still-moving routes each step, so the
    # per-step cost tracks the number of live walks, not E; the dense
    # padded view is materialized once (cached on the Graph) — a plain
    # row gather per step beats re-packing CSR rows every iteration
    dense = g.neighbors
    act = np.where(g.degrees[cur] > 0)[0]
    for _ in range(max_hops):
        if len(act) == 0:
            break
        nbrs = dense[cur[act]]                       # (A, D)
        valid = nbrs >= 0
        nb = np.where(valid, nbrs, 0)
        d = (cx[nb] - tx[act, None]) ** 2 + (cy[nb] - ty[act, None]) ** 2
        d[~valid] = np.inf
        best = np.argmin(d, axis=1)
        arange = np.arange(len(act))
        d_best = d[arange, best]
        mv = d_best < d_cur[act]
        if not mv.any():
            break
        moved = act[mv]
        new_cur = nbrs[arange, best][mv].astype(np.int64)
        cur[moved] = new_cur
        d_cur[moved] = d_best[mv]
        hops[moved] += 1
        col = np.full(E, -1, np.int32)
        col[moved] = new_cur
        cols.append(col)
        act = moved[g.degrees[new_cur] > 0]
    nodes = np.stack(cols, axis=1) if cols else np.full((E, 1), -1, np.int32)
    return BatchedRoutes(
        nodes=nodes, hops=hops.astype(np.int32), greedy_ok=np.ones(E, bool)
    )


def _batched_bfs(g: Graph, srcs: np.ndarray, dsts: np.ndarray) -> list:
    """Level-synchronous BFS for F (src, dst) pairs at once, reproducing
    the scalar FIFO BFS (`_bfs_path`) hop-for-hop: each discovered node's
    parent is its first discoverer in FIFO order, tracked via discovery
    ranks (rank * max_deg + neighbor-slot is the FIFO key)."""
    F, n, D = len(srcs), g.n, g.max_deg
    srcs = np.asarray(srcs, np.int64)
    dsts = np.asarray(dsts, np.int64)
    prev = np.full((F, n), -1, np.int64)
    rank = np.zeros((F, n), np.int64)
    prev[np.arange(F), srcs] = srcs
    next_rank = np.ones(F, np.int64)
    frontier_f, frontier_v = np.arange(F), srcs.copy()
    found = prev[np.arange(F), dsts] >= 0
    dense = g.neighbors  # cached; rows compact, so slots == CSR offsets
    while len(frontier_f):
        keep = ~found[frontier_f]
        ff, fv = frontier_f[keep], frontier_v[keep]
        if len(ff) == 0:
            break
        nbrs = dense[fv]                             # (M, D)
        mi, slot = np.nonzero(nbrs >= 0)
        cf, cu, cv = ff[mi], fv[mi], nbrs[mi, slot].astype(np.int64)
        undisc = prev[cf, cv] < 0
        cf, cu, cv, slot = cf[undisc], cu[undisc], cv[undisc], slot[undisc]
        if len(cf) == 0:
            break
        key = rank[cf, cu] * D + slot                # unique FIFO key per (f, u, slot)
        flat = cf * n + cv
        order = np.lexsort((key, flat))
        flat_s = flat[order]
        first = np.ones(len(flat_s), bool)
        first[1:] = flat_s[1:] != flat_s[:-1]        # min key per (f, v)
        sel = order[first]
        wf, wu, wv, wkey = cf[sel], cu[sel], cv[sel], key[sel]
        order2 = np.lexsort((wkey, wf))              # FIFO append order per f
        wf, wu, wv = wf[order2], wu[order2], wv[order2]
        counts = np.bincount(wf, minlength=F)
        starts = np.zeros(F, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        pos = np.arange(len(wf)) - starts[wf]
        prev[wf, wv] = wu
        rank[wf, wv] = next_rank[wf] + pos
        next_rank += counts
        found = prev[np.arange(F), dsts] >= 0
        frontier_f, frontier_v = wf, wv
    paths = []
    for f in range(F):
        if prev[f, dsts[f]] < 0:
            paths.append(None)
            continue
        p = [int(dsts[f])]
        while p[-1] != int(srcs[f]):
            p.append(int(prev[f, p[-1]]))
        paths.append(np.asarray(p[::-1], np.int32))
    return paths


# serial batching width for the greedy walker: 16k pairs x ~200 slots
# x 8B keeps each step's padded temporaries ~25MB (cache/allocator
# friendly on the same host DEFAULT_CHUNK was tuned for)
_ROUTE_CHUNK = 16_384


def _routes_chunk(payload, lohi) -> BatchedRoutes:
    """fork_map task: route one contiguous slice of the pair list (the
    payload graph/pairs arrive copy-on-write via the forked pool)."""
    g, pairs = payload
    lo, hi = lohi
    return batched_routes_to_nodes(g, pairs[lo:hi])


def _merge_batched_routes(parts: list[BatchedRoutes]) -> BatchedRoutes:
    """Concatenate per-chunk results in chunk order.  Routes for distinct
    pairs are independent, and every path array is (-1)-padded to
    max(hops)+1, so re-padding chunk results to the global width
    reproduces the serial output bitwise."""
    width = max(p.nodes.shape[1] for p in parts)
    nodes = np.full((sum(len(p) for p in parts), width), -1, np.int32)
    row = 0
    for p in parts:
        nodes[row:row + len(p), : p.nodes.shape[1]] = p.nodes
        row += len(p)
    return BatchedRoutes(
        nodes=nodes,
        hops=np.concatenate([p.hops for p in parts]),
        greedy_ok=np.concatenate([p.greedy_ok for p in parts]),
    )


def batched_routes_to_nodes(
    g: Graph, pairs: np.ndarray, workers: int = 0
) -> BatchedRoutes:
    """Batched `route_to_node` for an (E, 2) array of (src, dst) pairs:
    vectorized greedy walks for all pairs, then one batched BFS pass over
    the (rare) pairs whose greedy walk terminated elsewhere.

    ``workers > 1`` shards the pair list across a fork pool
    (`core.parallel.fork_map`); the chunk-order merge is bitwise-equal
    to the serial path.  Serial calls over more than `_ROUTE_CHUNK`
    pairs are chunked the same way in-process: every greedy step's
    temporaries are (live_pairs, max_deg) float64, so bounding the
    batch keeps them allocator- and cache-friendly — same result, one
    walk per pair either way."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    E = len(pairs)
    if workers > 1 and E >= 2 * workers:
        from .parallel import fork_map

        bounds = np.linspace(0, E, workers + 1).astype(np.int64)
        tasks = [
            (int(bounds[i]), int(bounds[i + 1])) for i in range(workers)
        ]
        parts = fork_map(
            _routes_chunk, tasks, workers=workers, payload=(g, pairs)
        )
        return _merge_batched_routes(parts)
    if E > _ROUTE_CHUNK:
        g.neighbors  # materialize the shared dense view once, not per chunk
        parts = [
            batched_routes_to_nodes(g, pairs[lo:lo + _ROUTE_CHUNK])
            for lo in range(0, E, _ROUTE_CHUNK)
        ]
        return _merge_batched_routes(parts)
    srcs, dsts = pairs[:, 0], pairs[:, 1]
    greedy = batched_greedy_routes(g, srcs, g.coords[dsts])
    final = greedy.nodes[np.arange(E), greedy.hops]
    fail = final != dsts
    if not fail.any():
        return greedy
    fidx = np.where(fail)[0]
    bfs_paths = _batched_bfs(g, srcs[fidx], dsts[fidx])
    hops = greedy.hops.copy()
    ok = np.ones(E, bool)
    ok[fidx] = False
    repl = {}
    for f, path in zip(fidx, bfs_paths):
        if path is None:   # disconnected: keep the greedy attempt (flagged)
            continue
        repl[int(f)] = path
        hops[f] = len(path) - 1
    Lmax = int(hops.max())
    nodes = np.full((E, Lmax + 1), -1, np.int32)
    w = min(greedy.nodes.shape[1], Lmax + 1)
    nodes[:, :w] = greedy.nodes[:, :w]
    for f, path in repl.items():
        nodes[f] = -1
        nodes[f, : len(path)] = path
    return BatchedRoutes(nodes=nodes, hops=hops.astype(np.int32), greedy_ok=ok)


def accumulate_route_sends(
    node_sends: np.ndarray, nodes: np.ndarray, hops: np.ndarray,
    weight: Optional[np.ndarray] = None,
) -> None:
    """Scatter-add per-node sends for request+reply traversals of padded
    routes: nodes[0..L-1] and nodes[L..1] each transmit once per use
    (`weight[e]` uses of route e, default 1) — the batched counterpart of
    `Route.send_counts`."""
    E, W = nodes.shape
    if E == 0 or W < 2:
        return
    col = np.arange(W)[None, :]
    fwd = col < hops[:, None]            # senders nodes[0..L-1]
    rep = (col >= 1) & (col <= hops[:, None])  # senders nodes[L..1]
    if weight is None:
        np.add.at(node_sends, nodes[fwd], 1)
        np.add.at(node_sends, nodes[rep], 1)
    else:
        wmat = np.broadcast_to(weight[:, None], (E, W))
        np.add.at(node_sends, nodes[fwd], wmat[fwd])
        np.add.at(node_sends, nodes[rep], wmat[rep])
