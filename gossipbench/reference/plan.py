"""The reference's own hierarchy plan for a deployment: the random
geometric graph, the recursive partition, the finest cells' induced
subgraphs, representative election, the overlay grids with their
greedy geographic routes, and the route-incidence arrays that
attribute each exchange's transmissions to nodes.

A frozen copy of the plain builder (numpy and scipy only, serial), with
one change of method: the graph comes from scipy's k-d tree pair search
rather than the program's cell-bucket scan, laid out in the same
canonical order (stencil offset, then node id, within each row).

`build(cfg)` returns a plain dict of numpy arrays; `load_or_build`
caches it as an ``.npz`` file.  Per level ``L<i>.``: ``nbr_start``,
``nbr_flat``, ``hop_flat``, ``degrees``, ``n_nodes``, ``slot_node``,
``max_hops``, ``kind`` (0 cells, 1 overlay); cells add ``row_node`` and
``partner_flat``; overlays add ``edge_pos_i``, ``edge_pos_j``,
``inc_node``, ``inc_edge``, ``inc_count`` and ``route_nodes``; a level
that promotes adds ``rep_slot``, ``line16``, ``next_graph`` and
``next_slot``.  At the top: ``coords``, ``graph_nbr_start``,
``graph_nbr_flat``, ``graph_degrees``, ``sides``, ``final_graph``,
``final_slot``, ``rep_counts``, ``disseminate``, ``levels``.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile

import numpy as np

# bump when the builder's output changes: old cache files then miss
VERSION = 1


# ---------------------------------------------------------------- graph
def _grid_side(r: float) -> int:
    return max(1, int(1.0 / r)) if r > 0 else 1


def random_geometric_graph(n: int, c: float, seed: int) -> dict:
    """n nodes uniform in the unit square, an edge where the distance is
    at most sqrt(c log n / n); CSR rows in canonical order."""
    from scipy.spatial import cKDTree

    coords = np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, 2))
    r = float(np.sqrt(c * np.log(n) / n))
    pairs = cKDTree(coords).query_pairs(r, output_type="ndarray").astype(
        np.int64)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    m = _grid_side(r)
    cx = np.clip((coords[:, 0] * m).astype(np.int64), 0, m - 1)
    cy = np.clip((coords[:, 1] * m).astype(np.int64), 0, m - 1)
    o = (cy[dst] - cy[src] + 1) * 3 + (cx[dst] - cx[src] + 1)
    perm = np.argsort((src * 9 + o) * n + dst, kind="stable")
    degrees = np.bincount(src, minlength=n).astype(np.int32)
    nbr_start = np.zeros(n + 1, np.int64)
    np.cumsum(degrees, out=nbr_start[1:])
    return dict(coords=coords, nbr_start=nbr_start,
                nbr_flat=dst[perm].astype(np.int32), degrees=degrees)


def _dense(g: dict) -> np.ndarray:
    """(n, max_deg) neighbour rows, -1 pad (cached on the dict)."""
    if "dense" not in g:
        deg = g["degrees"]
        D = max(1, int(deg.max(initial=0)))
        out = np.full((len(deg), D), -1, np.int32)
        out[np.arange(D)[None, :] < deg[:, None]] = g["nbr_flat"]
        g["dense"] = out
    return g["dense"]


# ------------------------------------------------------------ partition
def partition_sides(n: int, a: float, cell_max: float) -> tuple:
    """Sides of the level grids, level 1 (one cell) to the finest."""
    if n <= cell_max:
        k = 1
    else:
        k = max(2, 1 + math.ceil(
            math.log(math.log(cell_max) / math.log(n)) / math.log(a)))
    sides = [1]
    for _ in range(2, k + 1):
        q = n / sides[-1] ** 2
        sides.append(sides[-1] * max(2, round(q ** ((1.0 - a) / 2.0))))
    return tuple(sides)


def _cell_of(sides, coords, level):
    s = sides[level - 1]
    ij = np.minimum((coords * s).astype(np.int64), s - 1)
    return (ij[:, 1] * s + ij[:, 0]).astype(np.int64)


def _parent_cell(sides, level, cell):
    s_child, s_par = sides[level - 1], sides[level - 2]
    f = s_child // s_par
    cell = np.asarray(cell, np.int64)
    return (cell // s_child // f) * s_par + (cell % s_child) // f


def _child_grid_edges(sides, parent_level):
    s = sides[parent_level]
    f = s // sides[parent_level - 1]
    idx = np.arange(s * s, dtype=np.int64).reshape(s, s)
    keep = ((np.arange(s - 1) + 1) % f) != 0
    horiz = np.stack([idx[:, :-1][:, keep].ravel(),
                      idx[:, 1:][:, keep].ravel()], 1)
    vert = np.stack([idx[:-1, :][keep, :].ravel(),
                     idx[1:, :][keep, :].ravel()], 1)
    return np.concatenate([horiz, vert]).astype(np.int64)


# -------------------------------------------------------------- routing
def _greedy(g, srcs, targets):
    """Greedy geographic walks toward target points: each hop moves to
    the neighbour closest to the target while that gets closer."""
    E = len(srcs)
    coords, deg, dense = g["coords"], g["degrees"], _dense(g)
    cx, cy = coords[:, 0], coords[:, 1]
    cur = np.asarray(srcs, np.int64).copy()
    tx, ty = targets[:, 0], targets[:, 1]
    d_cur = (cx[cur] - tx) ** 2 + (cy[cur] - ty) ** 2
    hops = np.zeros(E, np.int64)
    cols = [cur.astype(np.int32)]
    act = np.where(deg[cur] > 0)[0]
    for _ in range(4 * len(deg)):
        if len(act) == 0:
            break
        nbrs = dense[cur[act]]
        valid = nbrs >= 0
        nb = np.where(valid, nbrs, 0)
        d = (cx[nb] - tx[act, None]) ** 2 + (cy[nb] - ty[act, None]) ** 2
        d[~valid] = np.inf
        best = np.argmin(d, axis=1)
        ar = np.arange(len(act))
        d_best = d[ar, best]
        mv = d_best < d_cur[act]
        if not mv.any():
            break
        moved = act[mv]
        new_cur = nbrs[ar, best][mv].astype(np.int64)
        cur[moved] = new_cur
        d_cur[moved] = d_best[mv]
        hops[moved] += 1
        col = np.full(E, -1, np.int32)
        col[moved] = new_cur
        cols.append(col)
        act = moved[deg[new_cur] > 0]
    return np.stack(cols, axis=1), hops.astype(np.int32)


def _bfs_path(g, src: int, dst: int):
    """FIFO breadth-first shortest path, neighbours in row order."""
    from collections import deque

    prev = np.full(len(g["degrees"]), -1, np.int64)
    prev[src] = src
    q = deque([src])
    s, flat, deg = g["nbr_start"], g["nbr_flat"], g["degrees"]
    while q:
        u = q.popleft()
        if u == dst:
            break
        for v in flat[s[u]:s[u] + deg[u]]:
            v = int(v)
            if prev[v] < 0:
                prev[v] = u
                q.append(v)
    if prev[dst] < 0:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(int(prev[path[-1]]))
    return np.asarray(path[::-1], np.int32)


def _routes_part(g, pairs):
    E = len(pairs)
    srcs, dsts = pairs[:, 0], pairs[:, 1]
    nodes, hops = _greedy(g, srcs, g["coords"][dsts])
    fail = nodes[np.arange(E), hops] != dsts
    if not fail.any():
        return nodes, hops
    repl = {}
    for f in np.nonzero(fail)[0]:
        path = _bfs_path(g, int(srcs[f]), int(dsts[f]))
        if path is not None:
            repl[int(f)] = path
            hops[f] = len(path) - 1
    out = np.full((E, int(hops.max()) + 1), -1, np.int32)
    w = min(nodes.shape[1], out.shape[1])
    out[:, :w] = nodes[:, :w]
    for f, path in repl.items():
        out[f] = -1
        out[f, :len(path)] = path
    return out, hops


def routes(g, pairs, chunk: int = 16_384):
    """Routes of (src, dst) pairs: greedy toward dst's location, then
    breadth-first where the walk stops elsewhere.  (E, L+1) node paths
    padded with -1, and (E,) hops."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    parts = [_routes_part(g, pairs[lo:lo + chunk])
             for lo in range(0, len(pairs), chunk)] or [
        (np.full((0, 1), -1, np.int32), np.zeros(0, np.int32))]
    width = max(p[0].shape[1] for p in parts)
    nodes = np.full((len(pairs), width), -1, np.int32)
    row = 0
    for p, _ in parts:
        nodes[row:row + len(p), :p.shape[1]] = p
        row += len(p)
    return nodes, np.concatenate([h for _, h in parts]).astype(np.int32)


# ----------------------------------------------------------------- plan
def _group_by(keys):
    m = len(keys)
    order = np.argsort(keys, kind="stable")
    uniq, counts = np.unique(keys[order], return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    group_of = np.empty(m, np.int64)
    group_of[order] = np.repeat(np.arange(len(uniq)), counts)
    loc_of = np.empty(m, np.int64)
    loc_of[order] = np.arange(m) - np.repeat(starts, counts)
    return order, uniq, group_of, loc_of, counts


def _components_per_group(num, src, dst, group_of, n_groups):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if len(src):
        adj = sp.coo_matrix((np.ones(len(src), np.int8), (src, dst)),
                            shape=(num, num))
        _, labels = connected_components(adj, directed=False)
    else:
        labels = np.arange(num)
    uniq = np.unique(group_of.astype(np.int64) * (num + 1) + labels)
    return np.bincount(uniq // (num + 1), minlength=n_groups)


def _connect(local_edges, coords, num):
    """Add nearest-pair edges until a group's grid is connected."""
    def find(parent, u):
        while parent[u] != u:
            parent[u] = parent[parent[u]]
            u = parent[u]
        return u

    while True:
        parent = np.arange(num)
        for u, v in local_edges:
            ru, rv = find(parent, int(u)), find(parent, int(v))
            if ru != rv:
                parent[ru] = rv
        comp = np.array([find(parent, u) for u in range(num)])
        labels = np.unique(comp)
        if len(labels) == 1:
            return local_edges
        a = np.where(comp == labels[0])[0]
        b = np.where(comp != labels[0])[0]
        d = np.sum((coords[a][:, None, :] - coords[b][None, :, :]) ** 2,
                   axis=2)
        ia, ib = np.unravel_index(int(np.argmin(d)), d.shape)
        local_edges.append((int(a[ia]), int(b[ib])))


def _starts(degrees):
    cs = np.concatenate([[0], np.cumsum(degrees.ravel().astype(np.int64))])
    return cs[:-1].reshape(degrees.shape).astype(np.int32)


def _line16(parents, n_nodes):
    porder = np.argsort(parents, kind="stable")
    uniq, counts = np.unique(parents[porder], return_counts=True)
    gidx = np.empty(len(parents), np.int64)
    gidx[porder] = np.repeat(np.arange(len(uniq)), counts)
    sizes = n_nodes.astype(np.float64)
    tot = np.bincount(gidx, weights=sizes, minlength=len(uniq))
    return (sizes * counts[gidx].astype(np.float64) / tot[gidx]).astype(
        np.float32)


def build(cfg: dict) -> dict:
    """The plan of configuration `cfg` (keys n, graph_seed, c, a,
    cell_max, plan_seed, rep_mode="random")."""
    if cfg["rep_mode"] != "random":
        raise ValueError("the reference elects at random only")
    g = random_geometric_graph(cfg["n"], cfg["c"], cfg["graph_seed"])
    n, coords = len(g["degrees"]), g["coords"]
    sides = partition_sides(n, cfg["a"], cfg["cell_max"])
    K = len(sides)
    if K < 2:
        raise ValueError("the reference plans two levels or more")
    rng = np.random.default_rng(cfg["plan_seed"])
    out = dict(coords=coords, graph_nbr_start=g["nbr_start"],
               graph_nbr_flat=g["nbr_flat"], graph_degrees=g["degrees"],
               sides=np.asarray(sides, np.int64))
    rep_counts = np.zeros(n, np.int64)
    levels = []

    # finest level: each cell's induced subgraph
    cell_of = _cell_of(sides, coords, K)
    _, cells, graph_of, local_of, sizes = _group_by(cell_of)
    B, C = len(cells), int(sizes.max())
    slot_node = np.full((B, C), -1, np.int32)
    slot_node[graph_of, local_of] = np.arange(n, dtype=np.int32)
    order = np.argsort(cell_of, kind="stable")
    src = np.repeat(np.arange(n, dtype=np.int64), g["degrees"])
    dst = g["nbr_flat"].astype(np.int64)
    keep = cell_of[src] == cell_of[dst]
    src, dst = src[keep], dst[keep]
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    perm = np.argsort(rank[src], kind="stable")   # rows in cell order
    src, dst = src[perm], dst[perm]
    degrees = np.zeros((B, C), np.int32)
    np.add.at(degrees, (graph_of[src], local_of[src]), 1)
    nnz = len(src)
    rep_slot = np.array([rng.integers(int(s)) for s in sizes], np.int32)
    rep_node = slot_node[np.arange(B), rep_slot].astype(np.int64)
    rep_counts[rep_node] += 1
    levels.append(dict(
        kind=0, nbr_start=_starts(degrees),
        nbr_flat=np.concatenate([local_of[dst], [0]]).astype(np.int32),
        hop_flat=np.ones(nnz + 1, np.int32), degrees=degrees,
        n_nodes=sizes.astype(np.int32), slot_node=slot_node, max_hops=1,
        row_node=np.concatenate([src, [n]]).astype(np.int32),
        partner_flat=np.concatenate([dst, [n]]).astype(np.int32),
        rep_slot=rep_slot,
        line16=_line16(_parent_cell(sides, K, cells), sizes)))
    cur_cells, cur_level = cells, K

    # overlay levels K-1 .. 1: grids of the representatives
    while cur_level > 1:
        j = cur_level - 1
        Bc = len(cur_cells)
        parents = _parent_cell(sides, cur_level, cur_cells)
        porder, uniq_par, group_of, loc_of, gcount = _group_by(parents)
        G = len(uniq_par)
        gstart = np.concatenate([[0], np.cumsum(gcount)])[:-1]
        levels[-1]["next_graph"] = group_of.astype(np.int32)
        levels[-1]["next_slot"] = loc_of.astype(np.int32)
        edges = _child_grid_edges(sides, j)
        pos_of = np.full(sides[cur_level - 1] ** 2, -1, np.int64)
        pos_of[cur_cells.astype(np.int64)] = np.arange(Bc)
        eu, ev = pos_of[edges[:, 0]], pos_of[edges[:, 1]]
        k2 = (eu >= 0) & (ev >= 0)
        eu, ev = eu[k2], ev[k2]
        same = group_of[eu] == group_of[ev]
        eu, ev = eu[same], ev[same]
        ge = group_of[eu]
        eord = np.argsort(ge, kind="stable")
        eu, ev, ge = eu[eord], ev[eord], ge[eord]
        lu, lv = loc_of[eu], loc_of[ev]
        ecount = np.bincount(ge, minlength=G)
        estart = np.concatenate([[0], np.cumsum(ecount)])[:-1]
        bad = np.nonzero(
            _components_per_group(Bc, eu, ev, group_of, G) > 1)[0]
        if len(bad):
            add = []
            for gg in bad:
                s0, m0 = int(estart[gg]), int(ecount[gg])
                base = list(zip(lu[s0:s0 + m0].tolist(),
                                lv[s0:s0 + m0].tolist()))
                members = porder[gstart[gg]:gstart[gg] + gcount[gg]]
                full = _connect(list(base), coords[rep_node[members]],
                                int(gcount[gg]))
                add += [(uu, vv, int(gg), m0 + i)
                        for i, (uu, vv) in enumerate(full[m0:])]
            a = np.asarray(add, np.int64).reshape(-1, 4)
            key = np.concatenate([np.arange(len(lu)) - estart[ge], a[:, 3]])
            lu = np.concatenate([lu, a[:, 0]])
            lv = np.concatenate([lv, a[:, 1]])
            ge = np.concatenate([ge, a[:, 2]])
            ford = np.lexsort((key, ge))
            lu, lv, ge = lu[ford], lv[ford], ge[ford]
        E = len(lu)
        cell_u = porder[gstart[ge] + lu]
        cell_v = porder[gstart[ge] + lv]
        rnodes, rhops = routes(
            g, np.stack([rep_node[cell_u], rep_node[cell_v]], axis=1))
        hops = np.maximum(1, rhops).astype(np.int64)
        # each undirected edge adds u's entry then v's; rows keep that
        # order
        Cg = int(gcount.max())
        ent_node = np.stack([lu, lv], 1).ravel()
        ent_other = np.stack([lv, lu], 1).ravel()
        rowid = np.repeat(ge, 2) * Cg + ent_node
        sord = np.argsort(rowid, kind="stable")
        degrees = np.bincount(rowid, minlength=G * Cg).astype(
            np.int32).reshape(G, Cg)
        start = _starts(degrees)
        slot = np.empty(2 * E, np.int64)
        rs = rowid[sord]
        first = np.searchsorted(rs, rs, side="left")
        slot[sord] = np.arange(2 * E) - first
        flatpos = start.ravel()[rowid] + slot
        slot_node = np.full((G, Cg), -1, np.int32)
        slot_node[group_of, loc_of] = rep_node.astype(np.int32)
        # one request and reply over a route: its ends send once, each
        # relay twice
        W = rnodes.shape[1]
        col = np.arange(W)[None, :]
        on = (col <= rhops[:, None]) & (rnodes >= 0) & (rhops[:, None] > 0)
        count = np.where((col == 0) | (col == rhops[:, None]), 1, 2)
        e_idx = np.broadcast_to(np.arange(E)[:, None], (E, W))
        lvl = dict(
            kind=1, nbr_start=start,
            nbr_flat=np.concatenate([ent_other[sord], [0]]).astype(np.int32),
            hop_flat=np.concatenate([np.repeat(hops, 2)[sord], [1]]).astype(
                np.int32),
            degrees=degrees, n_nodes=gcount.astype(np.int32),
            slot_node=slot_node,
            max_hops=int(hops.max()) if E else 1,
            edge_pos_i=flatpos[0::2].astype(np.int32),
            edge_pos_j=flatpos[1::2].astype(np.int32),
            inc_node=rnodes[on].astype(np.int32),
            inc_edge=e_idx[on].astype(np.int32),
            inc_count=count[on].astype(np.int32), route_nodes=rnodes)
        levels.append(lvl)
        if j == 1:
            break
        rep_slot = np.array([rng.integers(int(s)) for s in gcount], np.int32)
        rep_node = slot_node[np.arange(G), rep_slot].astype(np.int64)
        rep_counts[rep_node] += 1
        lvl["rep_slot"] = rep_slot
        lvl["line16"] = np.ones(G, np.float32)
        cur_cells, cur_level = uniq_par, j

    # every node reads its level-2 cell's slot in the single top grid
    top = int(levels[-1]["n_nodes"][0])
    slot_of = np.full(sides[1] ** 2, -1, np.int32)
    slot_of[cur_cells[:top].astype(np.int64)] = np.arange(top,
                                                          dtype=np.int32)
    final_slot = slot_of[_cell_of(sides, coords, 2)]
    if (final_slot < 0).any():
        raise ValueError("a node's level-2 cell is missing from the top grid")
    out.update(final_graph=np.zeros(n, np.int32),
               final_slot=final_slot.astype(np.int32), rep_counts=rep_counts,
               disseminate=np.bool_(True), levels=np.int64(len(levels)))
    for i, lvl in enumerate(levels):
        for name, a in lvl.items():
            out[f"L{i}.{name}"] = np.asarray(a)
    return out


def cache_key(cfg: dict) -> str:
    spec = {k: cfg[k] for k in ("n", "graph_seed", "c", "a", "cell_max",
                                "plan_seed", "rep_mode")}
    spec["version"] = VERSION
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def load_or_build(cfg: dict, cache_dir: str) -> dict:
    """The plan of `cfg`, from ``<cache_dir>/<key>.npz`` when it is there,
    else built and stored (atomically) first."""
    path = os.path.join(cache_dir, f"{cache_key(cfg)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    plan = build(cfg)
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **plan)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return plan
