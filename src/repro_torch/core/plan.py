"""Ahead-of-time hierarchy planning for the plan/execute simulation core.

The multiscale simulation splits into two halves:

* **plan** (this module, host/numpy): everything that depends only on
  the deployment — the recursive partition, induced-subgraph batches for
  every level, overlay grid edges (with nearest-pair augmentation for
  disconnected grids), representative election, batched greedy-geographic
  routes between representatives, and per-edge route-incidence CSR
  arrays so node-send attribution is a single scatter-add.  None of it
  depends on node *values*, so one plan serves any number of
  Monte-Carlo trials.
* **execute** (`core.engine`, device/PyTorch): runs all K levels through
  the batched gossip engine with promotion/reweighting expressed as
  gathers, with the Monte-Carlo trials folded into the graph batch.

Adjacency is CSR throughout `LevelPlan` (`nbr_start` / `nbr_flat` /
`hop_flat`, one flat entry per directed edge plus a trailing sentinel)
— the historical ``(B, C, D)`` dense padded arrays cost O(B*C*D) host
and device memory on the degree spread, which is what capped plans near
n=2000.  Dense views remain available as properties for small-n
consumers (`synchronous`, tests).

Two builders produce *identical* plans (same element order, same RNG
consumption, same floats — asserted by the parity tests):

* ``method="vectorized"`` (default): grouping via stable sorts, edges
  via one directed-edge flattening pass, per-parent overlay assembly as
  a handful of lexsorts, and connectivity via `scipy.sparse.csgraph`.
  The historical per-group edge filter was O(#groups × #grid-edges) —
  quadratic in n and the reason an n=10^5 build took ~450 s; the
  vectorized path is a few seconds.
* ``method="reference"``: the historical per-cell / per-group python
  loops, kept as the dense-path oracle.

`build_plan` records a `build_seconds` breakdown (partition / cells /
overlay / routes / incidence) on the returned `HierarchyPlan`, surfaced
as `plan_build_s` in benchmark artifacts.

A `HierarchyPlan` is built once per (graph, partition, election seed)
and is reusable across trials, eps targets, weighted/unweighted modes,
loss models, and engine backends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .gossip import batched_graphs
from .partition import Partition, build_partition
from .rgg import Graph, induced_subgraph
from .routing import BatchedRoutes, batched_routes_to_nodes
from .schedule import flat_usage_to_dense

__all__ = [
    "LevelPlan",
    "HierarchyPlan",
    "build_plan",
    "overlay_node_sends",
    "PLAN_METHODS",
]

PLAN_METHODS = ("vectorized", "reference")


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One hierarchy level, fully batched (B graphs, C slots).

    `kind == "cells"`: induced subgraphs of the finest cells; exchanges
    are single-hop.  `kind == "overlay"`: grids of representatives; each
    directed edge carries the greedy-route hop count of its edge.

    Adjacency is CSR: row ``(b, c)`` owns flat entries ``nbr_start[b, c]
    : nbr_start[b, c] + degrees[b, c]``; the flat arrays carry one
    trailing sentinel entry (neighbor 0, hops 1, attribution ids = n,
    the engine's trash slot) so edgeless levels stay well-formed.
    Dense ``(B, C, D)`` views are available as `neighbors` /
    `edge_hops` / `partner_node` properties — materialized on demand,
    for small-n consumers only.
    """

    level: int               # paper level: k (finest) down to 1 (top grid)
    kind: str                # "cells" | "overlay"
    nbr_start: np.ndarray    # (B, C) int32 flat offset of each row
    nbr_flat: np.ndarray     # (nnz+1,) int32 neighbor slot within the graph
    hop_flat: np.ndarray     # (nnz+1,) int32 per-directed-edge route hops
    degrees: np.ndarray      # (B, C) int32
    n_nodes: np.ndarray      # (B,) int32
    node_mask: np.ndarray    # (B, C) bool
    slot_node: np.ndarray    # (B, C) int32 global node id per slot, -1 pad
    max_hops: int            # longest routed exchange at this level
    max_deg: int             # D of the dense views
    # -- attribution --------------------------------------------------------
    # cells: global ids of each flat entry's owner and partner (sentinel n),
    # so per-node sends are two 1-D scatter-adds of the flat usage counters.
    row_node: Optional[np.ndarray]           # (nnz+1,) int32
    partner_flat: Optional[np.ndarray]       # (nnz+1,) int32
    # overlay: gather indices mapping each undirected edge e to its two
    # directed usage entries (flat positions), plus the route-incidence
    # CSR (entry p says: node inc_node[p] transmits inc_count[p] times per
    # use of edge inc_edge[p]) — attribution is usage_e gathered then
    # scatter-added.
    edge_b: Optional[np.ndarray]             # (E,) int32 graph index
    edge_i: Optional[np.ndarray]             # (E,) int32 endpoint slots
    edge_si: Optional[np.ndarray]            # (E,) int32 slot of v in i's row
    edge_j: Optional[np.ndarray]             # (E,)
    edge_sj: Optional[np.ndarray]            # (E,)
    edge_pos_i: Optional[np.ndarray]         # (E,) int32 flat usage index i->j
    edge_pos_j: Optional[np.ndarray]         # (E,) int32 flat usage index j->i
    inc_node: Optional[np.ndarray]           # (NNZ,) int32 global node ids
    inc_edge: Optional[np.ndarray]           # (NNZ,) int32 edge index
    inc_count: Optional[np.ndarray]          # (NNZ,) int32 sends per use
    routes: Optional[BatchedRoutes]          # the padded routes themselves
    # -- promotion to the next (coarser) level; None on the last level ------
    rep_slot: Optional[np.ndarray]           # (B,) int32 elected rep slot
    rep_node: Optional[np.ndarray]           # (B,) int64 global node id
    line16: Optional[np.ndarray]             # (B,) f32 Alg.1 line-16 factor
    next_graph: Optional[np.ndarray]         # (B,) int32 graph at next level
    next_slot: Optional[np.ndarray]          # (B,) int32 slot at next level

    @property
    def num_graphs(self) -> int:
        return int(self.degrees.shape[0])

    @property
    def nnz(self) -> int:
        """True directed-edge count (sentinel excluded)."""
        return int(self.nbr_flat.shape[0]) - 1

    @property
    def graph_sizes(self) -> tuple:
        return (
            int(self.n_nodes.min()),
            float(self.n_nodes.mean()),
            int(self.n_nodes.max()),
        )

    def _dense_view(self, flat: np.ndarray, fill) -> np.ndarray:
        B, C = self.degrees.shape
        deg = self.degrees.ravel().astype(np.int64)
        nnz = int(deg.sum())
        starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
        row = np.repeat(np.arange(B * C), deg)
        col = np.arange(nnz) - np.repeat(starts, deg)
        out = np.full((B * C, self.max_deg), fill, flat.dtype)
        out[row, col] = flat[:nnz]
        return out.reshape(B, C, self.max_deg)

    @property
    def neighbors(self) -> np.ndarray:
        """Dense (B, C, D) padded view, -1 pad — small-n consumers only."""
        return self._dense_view(self.nbr_flat, -1)

    @property
    def edge_hops(self) -> np.ndarray:
        """Dense (B, C, D) hop view, 1 pad (the historical padding)."""
        return self._dense_view(self.hop_flat, 1)

    @property
    def partner_node(self) -> Optional[np.ndarray]:
        """Dense (B, C, D) partner-global-id view, -1 pad ("cells" only)."""
        if self.partner_flat is None:
            return None
        n = int(self.partner_flat[-1])  # sentinel holds the trash id == n
        dense = self._dense_view(self.partner_flat, -1)
        dense[dense == n] = -1
        return dense

    def dense_usage(self, usage_flat: np.ndarray) -> np.ndarray:
        """Scatter flat (nnz+1,) usage counters to the dense (B, C, D)
        layout of the historical engine output."""
        return flat_usage_to_dense(usage_flat, self.degrees, self.max_deg)


@dataclasses.dataclass(eq=False)
class HierarchyPlan:
    """The full ahead-of-time pass: partition + per-level batches +
    routes + attribution, value-independent and trial-reusable."""

    graph: Graph
    partition: Partition
    levels: tuple            # LevelPlan, execution order: cells first, 1 last
    rep_counts: np.ndarray   # (n,) int64 — election is part of the plan
    disconnected_cells: int  # finest cells whose induced subgraph splits
    final_graph: np.ndarray  # (n,) int32 — where each node reads its
    final_slot: np.ndarray   # (n,) int32   final estimate (last level's x)
    disseminate: bool        # K >= 2: down-pass costs n messages
    seed: int
    rep_mode: str
    method: str = "vectorized"
    # host-side wall-clock breakdown of build_plan (seconds):
    # partition / cells / overlay / routes / incidence / total
    build_seconds: Optional[dict] = None

    @property
    def k(self) -> int:
        return self.partition.k


# --------------------------------------------------------------------------
# shared helpers (both builders)
# --------------------------------------------------------------------------


def _exclusive_starts(degrees: np.ndarray) -> tuple[np.ndarray, int]:
    """Row-major exclusive prefix sum of degrees → (start (B,C), nnz)."""
    deg = degrees.ravel().astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(deg)])
    return cs[:-1].reshape(degrees.shape).astype(np.int32), int(cs[-1])


def _csr_fields_from_dense(
    neighbors: np.ndarray,
    degrees: np.ndarray,
    edge_hops: Optional[np.ndarray] = None,
    slot_node: Optional[np.ndarray] = None,
    partner_node: Optional[np.ndarray] = None,
    n: Optional[int] = None,
) -> dict:
    """Flatten dense padded adjacency into the LevelPlan CSR fields.

    Entry order is the dense row order, so jidx draws address the same
    neighbor in both layouts.
    """
    B, C, D = neighbors.shape
    start, nnz = _exclusive_starts(degrees)
    keep = np.arange(D)[None, None, :] < degrees[:, :, None]
    nbr_flat = np.concatenate(
        [neighbors[keep].astype(np.int32), np.array([0], np.int32)]
    )
    if edge_hops is None:
        hop_flat = np.ones(nnz + 1, np.int32)
    else:
        hop_flat = np.concatenate(
            [np.asarray(edge_hops)[keep].astype(np.int32),
             np.array([1], np.int32)]
        )
    fields = dict(
        nbr_start=start, nbr_flat=nbr_flat, hop_flat=hop_flat, max_deg=D,
        row_node=None, partner_flat=None,
    )
    if partner_node is not None:
        deg = degrees.ravel().astype(np.int64)
        fields["row_node"] = np.concatenate(
            [np.repeat(slot_node.ravel(), deg),
             np.array([n])]
        ).astype(np.int32)
        fields["partner_flat"] = np.concatenate(
            [partner_node[keep], np.array([n])]
        ).astype(np.int32)
    return fields


def _line16_factors(parents: np.ndarray, n_nodes: np.ndarray) -> np.ndarray:
    """Alg. 1 line-16 reweighting: cell_size * (#siblings) / (parent
    population), grouped by parent.  One bincount pass; the per-group
    float64 sums accumulate in index order, shared by both builders so
    their plans stay bitwise-identical."""
    B = len(parents)
    porder = np.argsort(parents, kind="stable")
    uniq, counts = np.unique(parents[porder], return_counts=True)
    gidx = np.empty(B, np.int64)
    gidx[porder] = np.repeat(np.arange(len(uniq)), counts)
    sizes = n_nodes.astype(np.float64)
    tot = np.bincount(gidx, weights=sizes, minlength=len(uniq))
    return (sizes * counts[gidx].astype(np.float64) / tot[gidx]).astype(
        np.float32
    )


def _elect(
    rng: np.random.Generator,
    mode: str,
    num: int,
    coords: np.ndarray,
    center: np.ndarray,
) -> int:
    """Local index of the representative among `num` members."""
    if mode == "first":
        return 0
    if mode == "random":
        return int(rng.integers(num))
    d = np.sum((coords - center) ** 2, axis=1)
    return int(np.argmin(d))


def _grid_components(num: int, edges: np.ndarray) -> np.ndarray:
    """Union-find component labels for a small local graph."""
    parent = np.arange(num)

    def find(u):
        while parent[u] != u:
            parent[u] = parent[parent[u]]
            u = parent[u]
        return u

    for u, v in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[ru] = rv
    return np.array([find(u) for u in range(num)])


def _connect_components(local_edges: list, coords: np.ndarray, num: int) -> list:
    """Add nearest-pair edges until the local rep graph is connected
    (handles empty sibling cells — paper §VII 'disconnected grids')."""
    if num <= 1:
        return local_edges
    while True:
        comp = _grid_components(
            num, np.asarray(local_edges, np.int64).reshape(-1, 2)
        )
        labels = np.unique(comp)
        if len(labels) == 1:
            return local_edges
        a = np.where(comp == labels[0])[0]
        b = np.where(comp != labels[0])[0]
        d = np.sum((coords[a][:, None, :] - coords[b][None, :, :]) ** 2, axis=2)
        ia, ib = np.unravel_index(int(np.argmin(d)), d.shape)
        local_edges.append((int(a[ia]), int(b[ib])))


class _OverlayGraph:
    """Duck-typed graph (n / max_deg / neighbors / degrees) for batching,
    tracking which row slot each undirected edge landed in (reference
    builder only; the vectorized builder assembles CSR directly)."""

    def __init__(self, num: int, edges: np.ndarray, hops: np.ndarray):
        self.n = num
        nbrs: list[list[int]] = [[] for _ in range(num)]
        hp: list[list[int]] = [[] for _ in range(num)]
        self.slot_i = np.zeros(len(edges), np.int32)  # slot of v in u's row
        self.slot_j = np.zeros(len(edges), np.int32)  # slot of u in v's row
        for e, ((u, v), h) in enumerate(zip(edges, hops)):
            self.slot_i[e] = len(nbrs[u])
            nbrs[u].append(int(v))
            hp[u].append(int(h))
            self.slot_j[e] = len(nbrs[v])
            nbrs[v].append(int(u))
            hp[v].append(int(h))
        self.max_deg = max(1, max((len(r) for r in nbrs), default=1))
        self.neighbors = np.full((num, self.max_deg), -1, np.int32)
        self.edge_hops = np.ones((num, self.max_deg), np.int32)
        self.degrees = np.array([len(r) for r in nbrs], np.int32)
        for u in range(num):
            self.neighbors[u, : len(nbrs[u])] = nbrs[u]
            self.edge_hops[u, : len(hp[u])] = hp[u]


def _route_incidence(routes: BatchedRoutes) -> tuple:
    """CSR incidence (inc_node, inc_edge, inc_count) of padded routes:
    one request+reply exchange over edge e makes its path endpoints
    transmit once and interior nodes twice (2 * hops total)."""
    E, W = routes.nodes.shape
    col = np.arange(W)[None, :]
    hops = routes.hops[:, None]
    on_path = (col <= hops) & (routes.nodes >= 0)
    count = np.where((col == 0) | (col == hops), 1, 2)
    e_idx = np.broadcast_to(np.arange(E)[:, None], (E, W))
    keep = on_path & (hops > 0)
    return (
        routes.nodes[keep].astype(np.int32),
        e_idx[keep].astype(np.int32),
        count[keep].astype(np.int32),
    )


def overlay_node_sends(
    lp: LevelPlan, usage: np.ndarray, n: int
) -> np.ndarray:
    """Reference (numpy) overlay attribution: per-edge exchange counts
    gathered from the flat usage counters, scatter-added through the
    route-incidence CSR.  The engine runs the same computation in JAX."""
    usage = np.asarray(usage)
    usage_e = (usage[lp.edge_pos_i] + usage[lp.edge_pos_j]).astype(np.int64)
    sends = np.zeros(n, np.int64)
    np.add.at(sends, lp.inc_node, usage_e[lp.inc_edge] * lp.inc_count)
    return sends


def _dissemination_maps(
    part: Partition, cur_cells: np.ndarray, final_lp: LevelPlan, n: int,
    coords: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Every node reads its level-2 cell's slot in the final (level-1)
    grid, which is a single graph."""
    lvl2 = part.cell_of(coords, 2)
    slot_of_cell = np.full(part.num_cells(2), -1, np.int32)
    # final level slots hold reps of level-2 cells, ordered like cur_cells
    top = int(final_lp.n_nodes[0])
    slot_of_cell[cur_cells[:top].astype(np.int64)] = np.arange(top, dtype=np.int32)
    final_graph = np.zeros(n, np.int32)
    final_slot = slot_of_cell[lvl2]
    assert (final_slot >= 0).all(), "every node's level-2 cell must be present"
    return final_graph, final_slot.astype(np.int32)


# --------------------------------------------------------------------------
# reference builder (the historical per-cell / per-group loops)
# --------------------------------------------------------------------------


def _build_reference(
    g: Graph, part: Partition, rng: np.random.Generator,
    seed: int, rep_mode: str, timings: dict,
) -> HierarchyPlan:
    n = g.n
    K = part.k
    rep_counts = np.zeros(n, np.int64)
    levels: list[LevelPlan] = []

    # ---------------- finest level: induced cell subgraphs ----------------
    t0 = time.perf_counter()
    cell_of_node = part.cell_of(g.coords, K)
    present_cells = np.unique(cell_of_node)
    subgraphs, sub_ids = [], []
    for c in present_cells:
        sg, ids = induced_subgraph(g, np.where(cell_of_node == c)[0])
        subgraphs.append(sg)
        sub_ids.append(ids)
    disconnected = sum(0 if sg.is_connected() else 1 for sg in subgraphs)
    neighbors, degrees, n_nodes, mask = batched_graphs(subgraphs)
    B, C = mask.shape
    slot_node = np.full((B, C), -1, np.int32)
    for b, ids in enumerate(sub_ids):
        slot_node[b, : len(ids)] = ids
    # partner in each directed slot, as a global node id
    nbr_safe = np.clip(neighbors, 0, None)
    partner = np.where(
        neighbors >= 0, np.take_along_axis(
            np.broadcast_to(slot_node[:, :, None], neighbors.shape),
            nbr_safe, axis=1,
        ), -1,
    ).astype(np.int32)

    # elect finest-cell representatives + Alg.1 line-16 reweighting factor
    centers = part.cell_center(K, present_cells)
    rep_slot = np.zeros(B, np.int32)
    for b, ids in enumerate(sub_ids):
        rep_slot[b] = _elect(rng, rep_mode, len(ids), g.coords[ids], centers[b])
    rep_node = slot_node[np.arange(B), rep_slot].astype(np.int64)
    line16 = np.ones(B, np.float32)
    if K >= 2:
        parents = part.parent_cell(K, present_cells)
        line16 = _line16_factors(parents, n_nodes)

    base_kwargs = dict(
        level=K, kind="cells", degrees=degrees,
        n_nodes=n_nodes, node_mask=mask, slot_node=slot_node,
        max_hops=1,
        **_csr_fields_from_dense(
            neighbors, degrees, edge_hops=None, slot_node=slot_node,
            partner_node=partner, n=n,
        ),
        edge_b=None, edge_i=None, edge_si=None, edge_j=None, edge_sj=None,
        edge_pos_i=None, edge_pos_j=None,
        inc_node=None, inc_edge=None, inc_count=None, routes=None,
    )
    timings["cells"] += time.perf_counter() - t0

    if K == 1:
        # degenerate single-level run: no promotion, but the per-cell
        # election still happens (and is counted) as in Alg. 1
        rep_counts[rep_node] += 1
        levels.append(LevelPlan(
            **base_kwargs, rep_slot=None, rep_node=None, line16=None,
            next_graph=None, next_slot=None,
        ))
        final_graph = np.zeros(n, np.int32)
        final_slot = np.zeros(n, np.int32)
        for b, ids in enumerate(sub_ids):
            final_graph[ids] = b
            final_slot[ids] = np.arange(len(ids))
        return HierarchyPlan(
            graph=g, partition=part, levels=tuple(levels),
            rep_counts=rep_counts, disconnected_cells=disconnected,
            final_graph=final_graph, final_slot=final_slot,
            disseminate=False, seed=seed, rep_mode=rep_mode,
            method="reference",
        )

    rep_counts[rep_node] += 1
    cur_cells, cur_level = present_cells, K
    pending_base = base_kwargs  # promotion targets filled once grouped

    # ---------------- overlay levels k-1 .. 1 ----------------
    while cur_level > 1:
        j = cur_level - 1
        t0 = time.perf_counter()
        parents = part.parent_cell(cur_level, cur_cells)
        all_edges = part.child_grid_edges(j)
        order = np.argsort(parents, kind="stable")
        uniq_parents, starts = np.unique(parents[order], return_index=True)
        groups = np.split(order, starts[1:])

        # promotion mapping for the previous level
        next_graph = np.zeros(len(cur_cells), np.int32)
        next_slot = np.zeros(len(cur_cells), np.int32)
        for b, grp in enumerate(groups):
            next_graph[grp] = b
            next_slot[grp] = np.arange(len(grp))
        if pending_base is not None:
            levels.append(LevelPlan(
                **pending_base, rep_slot=rep_slot, rep_node=rep_node,
                line16=line16, next_graph=next_graph, next_slot=next_slot,
            ))
            pending_base = None
        else:
            prev = levels[-1]
            levels[-1] = dataclasses.replace(
                prev, rep_slot=rep_slot, rep_node=rep_node,
                line16=np.ones(prev.num_graphs, np.float32),
                next_graph=next_graph, next_slot=next_slot,
            )

        # per-parent overlay grids; route ALL edges of the level at once
        group_edges, group_sizes = [], []
        for grp in groups:
            cells_here = cur_cells[grp]
            local = {int(c): i for i, c in enumerate(cells_here)}
            edges = [
                (local[int(u)], local[int(v)])
                for u, v in all_edges
                if int(u) in local and int(v) in local
            ]
            edges = _connect_components(edges, g.coords[rep_node[grp]], len(grp))
            group_edges.append(edges)
            group_sizes.append(len(grp))
        flat_pairs = np.concatenate([
            np.stack([
                rep_node[grp[[u for u, _ in edges]]],
                rep_node[grp[[v for _, v in edges]]],
            ], axis=1) if edges else np.zeros((0, 2), np.int64)
            for grp, edges in zip(groups, group_edges)
        ]) if groups else np.zeros((0, 2), np.int64)
        timings["overlay"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        routes = batched_routes_to_nodes(g, flat_pairs)
        timings["routes"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        hops_all = np.maximum(1, routes.hops)
        level_max_hops = int(hops_all.max()) if len(hops_all) else 1

        overlay_graphs = []
        e0 = 0
        edge_b, edge_i, edge_si, edge_j, edge_sj = [], [], [], [], []
        for b, (grp, edges) in enumerate(zip(groups, group_edges)):
            m = len(edges)
            og = _OverlayGraph(
                len(grp), np.asarray(edges, np.int64).reshape(-1, 2),
                hops_all[e0 : e0 + m],
            )
            overlay_graphs.append(og)
            for e in range(m):
                u, v = edges[e]
                edge_b.append(b)
                edge_i.append(u)
                edge_si.append(og.slot_i[e])
                edge_j.append(v)
                edge_sj.append(og.slot_j[e])
            e0 += m

        neighbors, degrees, n_nodes, mask = batched_graphs(overlay_graphs)
        Bg, Cg = mask.shape
        edge_hops = np.ones((Bg, Cg, neighbors.shape[2]), np.int32)
        slot_node = np.full((Bg, Cg), -1, np.int32)
        for b, (og, grp) in enumerate(zip(overlay_graphs, groups)):
            edge_hops[b, : og.n, : og.max_deg] = og.edge_hops
            slot_node[b, : og.n] = rep_node[grp]
        csr = _csr_fields_from_dense(neighbors, degrees, edge_hops=edge_hops)
        edge_b = np.asarray(edge_b, np.int32)
        edge_i = np.asarray(edge_i, np.int32)
        edge_si = np.asarray(edge_si, np.int32)
        edge_j = np.asarray(edge_j, np.int32)
        edge_sj = np.asarray(edge_sj, np.int32)
        start = csr["nbr_start"]
        timings["overlay"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        inc_node, inc_edge, inc_count = _route_incidence(routes)
        timings["incidence"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        overlay_kwargs = dict(
            level=j, kind="overlay", degrees=degrees,
            n_nodes=n_nodes, node_mask=mask,
            slot_node=slot_node, max_hops=level_max_hops,
            **csr,
            edge_b=edge_b, edge_i=edge_i, edge_si=edge_si,
            edge_j=edge_j, edge_sj=edge_sj,
            edge_pos_i=(start[edge_b, edge_i] + edge_si).astype(np.int32),
            edge_pos_j=(start[edge_b, edge_j] + edge_sj).astype(np.int32),
            inc_node=inc_node, inc_edge=inc_edge, inc_count=inc_count,
            routes=routes,
        )

        if j == 1:
            levels.append(LevelPlan(
                **overlay_kwargs, rep_slot=None, rep_node=None, line16=None,
                next_graph=None, next_slot=None,
            ))
            timings["overlay"] += time.perf_counter() - t0
            break

        # elect a level-j representative per grid (promotion filled on the
        # next iteration, once the grouping at level j-1 is known)
        centers = part.cell_center(j, uniq_parents)
        rep_slot = np.zeros(Bg, np.int32)
        for b, grp in enumerate(groups):
            rep_slot[b] = _elect(
                rng, rep_mode, len(grp), g.coords[rep_node[grp]], centers[b]
            )
        new_rep_node = slot_node[np.arange(Bg), rep_slot].astype(np.int64)
        rep_counts[new_rep_node] += 1
        levels.append(LevelPlan(
            **overlay_kwargs, rep_slot=rep_slot, rep_node=new_rep_node,
            line16=np.ones(Bg, np.float32), next_graph=None, next_slot=None,
        ))
        rep_node = new_rep_node
        cur_cells, cur_level = uniq_parents, j
        timings["overlay"] += time.perf_counter() - t0

    final_graph, final_slot = _dissemination_maps(
        part, cur_cells, levels[-1], n, g.coords
    )
    return HierarchyPlan(
        graph=g, partition=part, levels=tuple(levels),
        rep_counts=rep_counts, disconnected_cells=disconnected,
        final_graph=final_graph, final_slot=final_slot,
        disseminate=True, seed=seed, rep_mode=rep_mode, method="reference",
    )


# --------------------------------------------------------------------------
# vectorized builder (default)
# --------------------------------------------------------------------------


def _group_by(keys: np.ndarray) -> tuple:
    """Stable grouping: returns (order, uniq, group_of, loc_of, counts)
    with `group_of[i]` the group index of element i and `loc_of[i]` its
    rank within the group (original order preserved — matches the
    reference builder's np.split over a stable argsort)."""
    m = len(keys)
    order = np.argsort(keys, kind="stable")
    uniq, counts = np.unique(keys[order], return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    group_of = np.empty(m, np.int64)
    group_of[order] = np.repeat(np.arange(len(uniq)), counts)
    loc_of = np.empty(m, np.int64)
    loc_of[order] = np.arange(m) - np.repeat(starts, counts)
    return order, uniq, group_of, loc_of, counts


def _components_per_group(
    num: int, src: Optional[np.ndarray], dst: Optional[np.ndarray],
    group_of: np.ndarray, n_groups: int,
    csr: Optional[tuple[np.ndarray, np.ndarray]] = None,
) -> np.ndarray:
    """#connected components per group for a graph on `num` vertices
    whose edges never cross groups.  Pass ``csr=(indptr, indices)`` when
    the adjacency is already in CSR layout — skips the COO build/sort,
    which dominates at nnz ~ 10^8."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if csr is not None:
        indptr, indices = csr
        if len(indices):
            adj = sp.csr_matrix(
                (np.ones(len(indices), np.int8), indices, indptr),
                shape=(num, num),
            )
            _, labels = connected_components(adj, directed=False)
        else:
            labels = np.arange(num)
    elif len(src):
        adj = sp.coo_matrix(
            (np.ones(len(src), np.int8), (src, dst)), shape=(num, num)
        )
        _, labels = connected_components(adj, directed=False)
    else:
        labels = np.arange(num)
    key = group_of.astype(np.int64) * (num + 1) + labels
    uniq = np.unique(key)
    return np.bincount(uniq // (num + 1), minlength=n_groups)


# nodes per sub-band of the in-cell edge scan: ~64k rows keeps every
# slice (flat ids, repeated cells, keep mask) a few MB — cache-resident
# on the same host the graph builder's chunk size was tuned for
_CELLS_BAND = 65_536


def _cells_edge_chunk(payload, lohi):
    """fork_map task: filter one contiguous NATURAL node range [lo, hi)
    of the CSR adjacency down to in-cell edges.  `nbr_flat` is scanned
    sequentially and the only gather is into the n-int32 cell-id table
    (cache-resident), so the pass is memory-bandwidth bound on one read
    of the flat slice — rank-ordering the survivors is the caller's
    O(kept) permute, not an O(nnz) reorder here.  Returns (kept-count
    per row, kept partner ids); chunks concatenated in task order
    reproduce the full natural-order edge stream bitwise."""
    nbr_start, nbr_flat, degrees, cell32 = payload
    lo, hi = lohi
    kept_counts, kept_dst = [], []
    for b0 in range(lo, hi, _CELLS_BAND):
        b1 = min(b0 + _CELLS_BAND, hi)
        s0 = int(nbr_start[b0])
        flat = nbr_flat[s0:int(nbr_start[b1])]
        keep = cell32[flat] == np.repeat(cell32[b0:b1], degrees[b0:b1])
        ck = np.zeros(len(flat) + 1, np.int64)
        np.cumsum(keep, out=ck[1:])
        bound = nbr_start[b0:b1 + 1] - s0
        kept_counts.append(ck[bound[1:]] - ck[bound[:-1]])
        kept_dst.append(flat[keep])
    if not kept_counts:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    return np.concatenate(kept_counts), np.concatenate(kept_dst)


def _build_vectorized(
    g: Graph, part: Partition, rng: np.random.Generator,
    seed: int, rep_mode: str, timings: dict, workers: int = 0,
) -> HierarchyPlan:
    n = g.n
    K = part.k
    rep_counts = np.zeros(n, np.int64)
    levels: list[LevelPlan] = []
    coords = g.coords

    # ---------------- finest level: induced cell subgraphs ----------------
    t0 = time.perf_counter()
    cell_of_node = part.cell_of(coords, K)
    _, present_cells, graph_of, local_of, cell_sizes = _group_by(cell_of_node)
    B = len(present_cells)
    C = int(cell_sizes.max())
    n_nodes = cell_sizes.astype(np.int32)
    mask = np.arange(C)[None, :] < n_nodes[:, None]
    slot_node = np.full((B, C), -1, np.int32)
    slot_node[graph_of, local_of] = np.arange(n, dtype=np.int32)

    # all in-cell directed edges, flattened in (node, row-slot) order —
    # exactly the induced_subgraph row order of the reference builder.
    # The filter scans the CSR in natural node order (the sequential,
    # cache-friendly direction; sharded over node ranges when
    # workers > 1), then permutes only the O(kept) survivors into rank
    # (cell-sorted) row order — never the O(nnz) stream.  The result is
    # the same edge sequence as the historical filter-then-stable-sort.
    order = np.argsort(cell_of_node, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    cell32 = cell_of_node.astype(np.int32)
    payload = (g.nbr_start, g.nbr_flat, g.degrees, cell32)
    if workers > 1 and n >= 2 * workers:
        from .parallel import fork_map

        bounds = np.linspace(0, n, workers + 1).astype(np.int64)
        tasks = [(int(bounds[i]), int(bounds[i + 1]))
                 for i in range(workers)]
        chunks = fork_map(
            _cells_edge_chunk, tasks, workers=workers, payload=payload
        )
    else:
        chunks = [_cells_edge_chunk(payload, (0, n))]
    kept_nat = np.concatenate([c[0] for c in chunks])  # natural row order
    dst_nat = np.concatenate([c[1] for c in chunks])
    # natural -> rank row order: within-row order is CSR order on both
    # sides, so each row just shifts by (rank-space start - natural one)
    kept_ord = kept_nat[order]
    out_start = np.zeros(n, np.int64)
    np.cumsum(kept_ord[:-1], out=out_start[1:])
    nat_start = np.zeros(n, np.int64)
    np.cumsum(kept_nat[:-1], out=nat_start[1:])
    pos = (
        np.repeat(out_start[rank] - nat_start, kept_nat)
        + np.arange(len(dst_nat), dtype=np.int64)
    )
    dst = np.empty_like(dst_nat)
    dst[pos] = dst_nat
    src = np.repeat(order.astype(np.int32), kept_ord)
    degrees = np.zeros((B, C), np.int32)
    degrees[graph_of, local_of] = kept_nat.astype(np.int32)
    nbr_start, nnz = _exclusive_starts(degrees)
    nbr_flat = np.concatenate(
        [local_of[dst], [0]]
    ).astype(np.int32)
    hop_flat = np.ones(nnz + 1, np.int32)
    row_node = np.concatenate([src, [n]]).astype(np.int32)
    partner_flat = np.concatenate([dst, [n]]).astype(np.int32)
    max_deg = max(1, int(kept_nat.max(initial=0)))

    # disconnected-cell count via sparse connected components, fed the
    # rank-space CSR we already hold (COO build/sort skipped)
    comp_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(kept_ord, out=comp_indptr[1:])
    comp_per_cell = _components_per_group(
        n, None, None, graph_of[order], B,
        csr=(comp_indptr, rank[dst]),
    )
    disconnected = int((comp_per_cell > 1).sum())

    # elect finest-cell representatives + Alg.1 line-16 reweighting factor
    centers = part.cell_center(K, present_cells)
    rep_slot = np.zeros(B, np.int32)
    if rep_mode == "random":
        for b in range(B):
            rep_slot[b] = int(rng.integers(int(cell_sizes[b])))
    elif rep_mode != "first":
        order = np.argsort(cell_of_node, kind="stable")
        d = np.sum((coords[order] - centers[graph_of[order]]) ** 2, axis=1)
        # first-minimum per group, matching np.argmin's tie-break
        o2 = np.lexsort((np.arange(n), d, graph_of[order]))
        firsts = o2[np.unique(graph_of[order][o2], return_index=True)[1]]
        rep_slot = (firsts - np.concatenate(
            [[0], np.cumsum(cell_sizes)])[:-1][graph_of[order][firsts]]
        ).astype(np.int32)
    rep_node = slot_node[np.arange(B), rep_slot].astype(np.int64)
    line16 = np.ones(B, np.float32)
    if K >= 2:
        parents = part.parent_cell(K, present_cells)
        line16 = _line16_factors(parents, n_nodes)

    base_kwargs = dict(
        level=K, kind="cells", degrees=degrees, n_nodes=n_nodes,
        node_mask=mask, slot_node=slot_node, max_hops=1,
        nbr_start=nbr_start, nbr_flat=nbr_flat, hop_flat=hop_flat,
        max_deg=max_deg, row_node=row_node, partner_flat=partner_flat,
        edge_b=None, edge_i=None, edge_si=None, edge_j=None, edge_sj=None,
        edge_pos_i=None, edge_pos_j=None,
        inc_node=None, inc_edge=None, inc_count=None, routes=None,
    )
    timings["cells"] += time.perf_counter() - t0

    if K == 1:
        rep_counts[rep_node] += 1
        levels.append(LevelPlan(
            **base_kwargs, rep_slot=None, rep_node=None, line16=None,
            next_graph=None, next_slot=None,
        ))
        return HierarchyPlan(
            graph=g, partition=part, levels=tuple(levels),
            rep_counts=rep_counts, disconnected_cells=disconnected,
            final_graph=graph_of.astype(np.int32),
            final_slot=local_of.astype(np.int32),
            disseminate=False, seed=seed, rep_mode=rep_mode,
        )

    rep_counts[rep_node] += 1
    cur_cells, cur_level = present_cells, K
    pending_base = base_kwargs

    # ---------------- overlay levels k-1 .. 1 ----------------
    while cur_level > 1:
        j = cur_level - 1
        t0 = time.perf_counter()
        Bc = len(cur_cells)
        parents = part.parent_cell(cur_level, cur_cells)
        porder, uniq_parents, group_of, loc_of, gcount = _group_by(parents)
        G = len(uniq_parents)
        gstart = np.concatenate([[0], np.cumsum(gcount)])[:-1]

        # promotion mapping for the previous level
        next_graph = group_of.astype(np.int32)
        next_slot = loc_of.astype(np.int32)
        if pending_base is not None:
            levels.append(LevelPlan(
                **pending_base, rep_slot=rep_slot, rep_node=rep_node,
                line16=line16, next_graph=next_graph, next_slot=next_slot,
            ))
            pending_base = None
        else:
            prev = levels[-1]
            levels[-1] = dataclasses.replace(
                prev, rep_slot=rep_slot, rep_node=rep_node,
                line16=np.ones(prev.num_graphs, np.float32),
                next_graph=next_graph, next_slot=next_slot,
            )

        # base grid edges, mapped to positions in cur_cells and grouped by
        # parent in one pass (the reference builder's per-group filter over
        # ALL grid edges was the quadratic hot spot at large n)
        all_edges = part.child_grid_edges(j)
        pos_of = np.full(part.num_cells(cur_level), -1, np.int64)
        pos_of[cur_cells.astype(np.int64)] = np.arange(Bc)
        eu = pos_of[all_edges[:, 0]]
        ev = pos_of[all_edges[:, 1]]
        ekeep = (eu >= 0) & (ev >= 0)
        eu, ev = eu[ekeep], ev[ekeep]
        same = group_of[eu] == group_of[ev]
        eu, ev = eu[same], ev[same]
        ge = group_of[eu]
        eord = np.argsort(ge, kind="stable")
        eu, ev, ge = eu[eord], ev[eord], ge[eord]
        lu, lv = loc_of[eu], loc_of[ev]
        E = len(lu)
        ecount = np.bincount(ge, minlength=G)
        estart = np.concatenate([[0], np.cumsum(ecount)])[:-1]

        # repair disconnected groups exactly like the reference builder:
        # detect with sparse connected components (cheap), then run the
        # sequential nearest-pair augmentation on just those groups
        comp_per_group = _components_per_group(Bc, eu, ev, group_of, G)
        bad = np.nonzero(comp_per_group > 1)[0]
        if len(bad):
            add_u, add_v, add_g, add_k = [], [], [], []
            for gg in bad:
                s0, m0 = int(estart[gg]), int(ecount[gg])
                base = list(zip(lu[s0 : s0 + m0].tolist(),
                                lv[s0 : s0 + m0].tolist()))
                members = porder[gstart[gg] : gstart[gg] + gcount[gg]]
                full = _connect_components(
                    list(base), coords[rep_node[members]], int(gcount[gg])
                )
                for idx, (uu, vv) in enumerate(full[m0:]):
                    add_u.append(uu)
                    add_v.append(vv)
                    add_g.append(int(gg))
                    add_k.append(m0 + idx)
            base_key = np.arange(E) - estart[ge]
            lu = np.concatenate([lu, np.asarray(add_u, np.int64)])
            lv = np.concatenate([lv, np.asarray(add_v, np.int64)])
            ge = np.concatenate([ge, np.asarray(add_g, np.int64)])
            ekey = np.concatenate([base_key, np.asarray(add_k, np.int64)])
            ford = np.lexsort((ekey, ge))
            lu, lv, ge = lu[ford], lv[ford], ge[ford]
            E = len(lu)
            ecount = np.bincount(ge, minlength=G)
            estart = np.concatenate([[0], np.cumsum(ecount)])[:-1]
        timings["overlay"] += time.perf_counter() - t0

        # route ALL edges of the level at once
        t0 = time.perf_counter()
        cell_u = porder[gstart[ge] + lu] if E else np.zeros(0, np.int64)
        cell_v = porder[gstart[ge] + lv] if E else np.zeros(0, np.int64)
        flat_pairs = np.stack(
            [rep_node[cell_u], rep_node[cell_v]], axis=1
        ) if E else np.zeros((0, 2), np.int64)
        routes = batched_routes_to_nodes(g, flat_pairs, workers=workers)
        timings["routes"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        hops_all = np.maximum(1, routes.hops)
        level_max_hops = int(hops_all.max()) if len(hops_all) else 1

        # CSR overlay adjacency: each undirected edge contributes its two
        # directed entries in append order (u's entry then v's), so a
        # stable sort by row reproduces the reference row layout
        Cg = int(gcount.max())
        ent_g = np.repeat(ge, 2)
        ent_node = np.empty(2 * E, np.int64)
        ent_node[0::2] = lu
        ent_node[1::2] = lv
        ent_other = np.empty(2 * E, np.int64)
        ent_other[0::2] = lv
        ent_other[1::2] = lu
        ent_hop = np.repeat(hops_all.astype(np.int64), 2)
        rowid = ent_g * Cg + ent_node
        sord = np.argsort(rowid, kind="stable")
        rs = rowid[sord]
        newrun = np.concatenate([[True], rs[1:] != rs[:-1]]) \
            if len(rs) else np.zeros(0, bool)
        runstart = np.nonzero(newrun)[0]
        runidx = np.cumsum(newrun) - 1
        slot_sorted = np.arange(2 * E) - runstart[runidx] \
            if len(rs) else np.zeros(0, np.int64)
        slot = np.empty(2 * E, np.int64)
        slot[sord] = slot_sorted
        degrees = np.bincount(
            rowid, minlength=G * Cg
        ).astype(np.int32).reshape(G, Cg)
        nbr_start, nnz = _exclusive_starts(degrees)
        nbr_flat = np.concatenate([ent_other[sord], [0]]).astype(np.int32)
        hop_flat = np.concatenate([ent_hop[sord], [1]]).astype(np.int32)
        max_deg = max(1, int(degrees.max(initial=0)))
        flatpos = nbr_start.ravel()[rowid] + slot
        n_nodes = gcount.astype(np.int32)
        mask = np.arange(Cg)[None, :] < n_nodes[:, None]
        slot_node = np.full((G, Cg), -1, np.int32)
        slot_node[group_of, loc_of] = rep_node.astype(np.int32)
        timings["overlay"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        inc_node, inc_edge, inc_count = _route_incidence(routes)
        timings["incidence"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        overlay_kwargs = dict(
            level=j, kind="overlay", degrees=degrees, n_nodes=n_nodes,
            node_mask=mask, slot_node=slot_node, max_hops=level_max_hops,
            nbr_start=nbr_start, nbr_flat=nbr_flat, hop_flat=hop_flat,
            max_deg=max_deg, row_node=None, partner_flat=None,
            edge_b=ge.astype(np.int32),
            edge_i=lu.astype(np.int32),
            edge_si=slot[0::2].astype(np.int32),
            edge_j=lv.astype(np.int32),
            edge_sj=slot[1::2].astype(np.int32),
            edge_pos_i=flatpos[0::2].astype(np.int32),
            edge_pos_j=flatpos[1::2].astype(np.int32),
            inc_node=inc_node, inc_edge=inc_edge, inc_count=inc_count,
            routes=routes,
        )

        if j == 1:
            levels.append(LevelPlan(
                **overlay_kwargs, rep_slot=None, rep_node=None, line16=None,
                next_graph=None, next_slot=None,
            ))
            timings["overlay"] += time.perf_counter() - t0
            break

        # elect a level-j representative per grid (promotion filled on the
        # next iteration, once the grouping at level j-1 is known)
        centers = part.cell_center(j, uniq_parents)
        rep_slot = np.zeros(G, np.int32)
        if rep_mode == "random":
            for b in range(G):
                rep_slot[b] = int(rng.integers(int(gcount[b])))
        elif rep_mode != "first":
            for b in range(G):
                members = porder[gstart[b] : gstart[b] + gcount[b]]
                d = np.sum(
                    (coords[rep_node[members]] - centers[b]) ** 2, axis=1
                )
                rep_slot[b] = int(np.argmin(d))
        new_rep_node = slot_node[np.arange(G), rep_slot].astype(np.int64)
        rep_counts[new_rep_node] += 1
        levels.append(LevelPlan(
            **overlay_kwargs, rep_slot=rep_slot, rep_node=new_rep_node,
            line16=np.ones(G, np.float32), next_graph=None, next_slot=None,
        ))
        rep_node = new_rep_node
        cur_cells, cur_level = uniq_parents, j
        timings["overlay"] += time.perf_counter() - t0

    final_graph, final_slot = _dissemination_maps(
        part, cur_cells, levels[-1], n, coords
    )
    return HierarchyPlan(
        graph=g, partition=part, levels=tuple(levels),
        rep_counts=rep_counts, disconnected_cells=disconnected,
        final_graph=final_graph, final_slot=final_slot,
        disseminate=True, seed=seed, rep_mode=rep_mode,
    )


def build_plan(
    g: Graph,
    *,
    k: Optional[int] = None,
    a: float = 2.0 / 3.0,
    cell_max: float = 8.0,
    seed: int = 0,
    rep_mode: str = "random",
    method: str = "vectorized",
    workers: int = 0,
) -> HierarchyPlan:
    """One ahead-of-time pass over the deployment: partition, batched
    induced subgraphs, overlay grids, representative election, batched
    routes, and attribution CSR for every level.

    `method="vectorized"` (default) and `method="reference"` build
    bitwise-identical plans; the reference path keeps the historical
    python loops as the oracle (it is quadratic in n — use it only at
    fig3 scales).

    ``workers > 1`` shards the cell-filter and routing stages of the
    vectorized builder across a fork pool (`core.parallel`); the output
    is bitwise-identical to the serial build (tested), so the knob is
    purely a wall-clock lever on multi-core hosts.  It never changes
    the plan, and is excluded from the plan-cache key.
    """
    if method not in PLAN_METHODS:
        raise ValueError(f"unknown plan method {method!r}")
    timings = {"partition": 0.0, "cells": 0.0, "overlay": 0.0,
               "routes": 0.0, "incidence": 0.0}
    t_all = time.perf_counter()
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    part = build_partition(g.n, k=k, a=a, cell_max=cell_max)
    timings["partition"] += time.perf_counter() - t0
    if method == "vectorized":
        plan = _build_vectorized(
            g, part, rng, seed, rep_mode, timings, workers=workers
        )
    else:
        plan = _build_reference(g, part, rng, seed, rep_mode, timings)
    timings["total"] = time.perf_counter() - t_all
    timings["workers"] = workers
    plan.build_seconds = {kk: round(v, 6) for kk, v in timings.items()}
    return plan
