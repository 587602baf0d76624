"""Random geometric graph (RGG) and grid topologies (paper §II).

The paper's connectivity model: n nodes uniform in the unit square, edge
iff Euclidean distance <= r(n) = sqrt(c * log(n) / n).  The paper's
experiments use c = 3 (r = sqrt(3 log n / n)), which also guarantees the
geo-density property used in §V (every r x r patch holds Theta(log n)
nodes w.h.p.).

Graphs are stored in CSR adjacency so construction and planning stay
O(nnz) in memory at large n:

  nbr_start : (n+1,) int64   -- row offsets into nbr_flat
  nbr_flat  : (nnz,) int32   -- one entry per directed edge
  degrees   : (n,)   int32
  coords    : (n, 2) float64

A dense padded ``(n, max_deg)`` view remains available as the
`neighbors` property (materialized lazily, cached) for small-n
consumers; large-n code paths use `neighbor_rows` to gather just the
rows they touch.

Two RGG builders produce bitwise-identical CSR (asserted by the parity
suite in tests/test_rgg_builders.py):

* ``method="bucket"`` (default): the geo-density construction — coords
  hash into an r-sized grid, neighbors come from the 9-cell stencil
  with vectorized numpy per bucket block, and the CSR is emitted
  directly, streamed in node-chunks so peak RSS is O(chunk + nnz)
  instead of the historical O(n * max_deg) padded intermediate.
* ``method="reference"``: the historical cKDTree ``query_pairs`` path,
  kept as the oracle (its pair *set* equals the bucket predicate; its
  output is reordered into the shared canonical layout).

Canonical neighbor order (both builders): row u lists partners grouped
by the 3x3 stencil offset of their cell relative to u's cell (row-major
offsets, so same-cell partners sit in the middle run), ascending node id
within each run.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "random_geometric_graph",
    "grid_graph",
    "connectivity_radius",
    "induced_subgraph",
    "RGG_METHODS",
]

RGG_METHODS = ("bucket", "reference")

# default node-chunk target of the streamed bucket builder: bounds the
# per-band candidate arrays (~9 * avg_cell_occupancy * chunk entries)
# and keeps the band working set cache-resident — measured sweet spot
# on the single-core CI host (16.9s at n=10^6 vs 116s at chunk=250k)
DEFAULT_CHUNK = 8_000


def connectivity_radius(n: int, c: float = 3.0) -> float:
    """r(n) = sqrt(c log n / n) (paper §II, experiments use c=3)."""
    return float(np.sqrt(c * np.log(n) / n))


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR-adjacency graph embedded in the unit square."""

    coords: np.ndarray      # (n, 2) float64, positions in [0,1]^2
    nbr_start: np.ndarray   # (n+1,) int64 row offsets into nbr_flat
    nbr_flat: np.ndarray    # (nnz,) int32 one entry per directed edge
    degrees: np.ndarray     # (n,) int32
    radius: float

    @property
    def n(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.nbr_flat.shape[0])

    @cached_property
    def max_deg(self) -> int:
        return max(1, int(self.degrees.max(initial=0)))

    @property
    def num_edges(self) -> int:
        return int(self.degrees.sum()) // 2

    @cached_property
    def neighbors(self) -> np.ndarray:
        """Dense (n, max_deg) padded view, -1 pad — materialized lazily
        and cached (O(n * max_deg) memory).  Built by boolean-mask
        assignment: the mask enumerates in-degree slots in C order,
        which is exactly the CSR flat order, so one sequential pass
        fills the view — no per-element index matrices."""
        if self.n == 0:
            return np.full((0, 1), -1, np.int32)
        D = self.max_deg
        out = np.full((self.n, D), -1, np.int32)
        mask = np.arange(D)[None, :] < self.degrees[:, None]
        out[mask] = self.nbr_flat
        return out

    def neighbor_rows(self, ids: np.ndarray) -> np.ndarray:
        """Padded (len(ids), D) neighbor rows for just the given nodes,
        D = max degree among them — the large-n row gather used by the
        batched routers instead of the dense `neighbors` view."""
        ids = np.asarray(ids, np.int64)
        deg = self.degrees[ids].astype(np.int64)
        D = max(1, int(deg.max(initial=0)))
        col = np.arange(D)[None, :]
        valid = col < deg[:, None]
        if self.nnz == 0:
            return np.full((len(ids), D), -1, np.int32)
        idx = np.minimum(self.nbr_start[ids][:, None] + col, self.nnz - 1)
        return np.where(valid, self.nbr_flat[idx], np.int32(-1))

    def edge_list(self) -> np.ndarray:
        """(m, 2) int32 array of undirected edges (i < j)."""
        rows = np.repeat(
            np.arange(self.n, dtype=np.int64), self.degrees.astype(np.int64)
        )
        cols = self.nbr_flat.astype(np.int64)
        mask = rows < cols
        return np.stack([rows[mask], cols[mask]], axis=1).astype(np.int32)

    def is_connected(self) -> bool:
        return _num_components(self) == 1

    def subgraph_labels(self) -> np.ndarray:
        """Connected-component label per node (sparse csgraph pass)."""
        return _component_labels(self)

    # dense-era constructors kept for callers that assemble adjacency
    # by hand (tests, synthetic topologies)
    @classmethod
    def from_padded(
        cls, coords: np.ndarray, neighbors: np.ndarray,
        degrees: np.ndarray, radius: float,
    ) -> "Graph":
        """Build from the historical (n, max_deg) padded layout."""
        degrees = np.asarray(degrees, np.int32)
        deg = degrees.astype(np.int64)
        n, D = neighbors.shape
        keep = np.arange(D)[None, :] < deg[:, None]
        nbr_flat = np.asarray(neighbors)[keep].astype(np.int32)
        nbr_start = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=nbr_start[1:])
        return cls(
            coords=coords, nbr_start=nbr_start, nbr_flat=nbr_flat,
            degrees=degrees, radius=float(radius),
        )

    @classmethod
    def from_pairs(
        cls, coords: np.ndarray, pairs: np.ndarray, radius: float
    ) -> "Graph":
        """Build from an (m, 2) undirected pair list, preserving pair
        order within each row (the historical `_adjacency_from_pairs`
        layout, used by the grid topology and synthetic tests)."""
        n = len(coords)
        nbr_start, nbr_flat, degrees = _csr_from_pairs(n, pairs)
        return cls(
            coords=coords, nbr_start=nbr_start, nbr_flat=nbr_flat,
            degrees=degrees, radius=float(radius),
        )

    # cached dense views must not ride along into pickles (plan cache,
    # process pools) — they are derivable and can be huge
    def __getstate__(self):
        return {
            k: v for k, v in self.__dict__.items()
            if k not in ("neighbors", "max_deg")
        }

    def __setstate__(self, state):
        self.__dict__.update(state)


def _csr_from_pairs(
    n: int, pairs: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR adjacency from an (m, 2) undirected pair list; row order is
    the stable-by-source order of [pairs; flipped pairs] (the historical
    padded layout, flattened)."""
    pairs = np.asarray(pairs)
    if pairs.size == 0:
        return np.zeros(n + 1, np.int64), np.zeros(0, np.int32), \
            np.zeros(n, np.int32)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    degrees = np.bincount(src, minlength=n).astype(np.int32)
    nbr_start = np.zeros(n + 1, np.int64)
    np.cumsum(degrees, out=nbr_start[1:])
    return nbr_start, dst[order].astype(np.int32), degrees


# --------------------------------------------------------------------------
# bucketed streamed builder (default) + cKDTree reference
# --------------------------------------------------------------------------


def _grid_side(r: float) -> int:
    """Bucket-grid side m with cell width 1/m >= r, so the full radius-r
    neighborhood of any point lies inside the 3x3 cell stencil."""
    if r <= 0:
        return 1
    return max(1, int(1.0 / r))


def _bucket_cells(coords: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(cx, cy) int64 bucket coordinates of each node."""
    cx = np.clip((coords[:, 0] * m).astype(np.int64), 0, m - 1)
    cy = np.clip((coords[:, 1] * m).astype(np.int64), 0, m - 1)
    return cx, cy

# the canonical per-row run order: 3x3 stencil offsets, row-major
_STENCIL = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _excl_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a, out=out[1:])
    return out


def _bucket_csr(
    coords: np.ndarray, r: float, chunk: int = DEFAULT_CHUNK
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cell-bucketed CSR construction: stream bands of bucket rows,
    compare each band's nodes against their 9-cell stencil with
    vectorized numpy, and assemble each band's CSR rows immediately
    while the band's working set is still cache-hot (no padded
    intermediate, no O(n)-sized temporaries per band).

    Peak extra memory is O(chunk-band candidates + nnz); the per-row
    entry order is the canonical (stencil offset, ascending node id)
    layout shared with `method="reference"`.  `chunk` only tiles the
    work — the output is bitwise-invariant to it (tested).
    """
    n = len(coords)
    m = _grid_side(r)
    cx, cy = _bucket_cells(coords, m)
    cell = cy * m + cx
    # nodes grouped by cell, ascending node id within a cell
    order = np.argsort(cell, kind="stable")
    counts = np.bincount(cell, minlength=m * m).astype(np.int64)
    cstart = _excl_cumsum(counts)
    # cell-sorted coordinate copies: candidate gathers hit a small
    # contiguous window instead of striding the (n, 2) layout
    xs = np.ascontiguousarray(coords[order, 0])
    ys = np.ascontiguousarray(coords[order, 1])
    r2 = r * r

    # bands of whole bucket rows sized to ~chunk nodes each
    row_counts = counts.reshape(m, m).sum(axis=1)
    bands: list[tuple[int, int]] = []
    y0 = 0
    acc = 0
    for y in range(m):
        acc += int(row_counts[y])
        if acc >= max(1, chunk) or y == m - 1:
            bands.append((y0, y + 1))
            y0, acc = y + 1, 0
    if y0 < m:
        bands.append((y0, m))

    # degree per *sorted position*; remapped to node ids at the end
    deg_sorted = np.zeros(n, np.int64)
    band_payload: list[tuple[int, int, np.ndarray]] = []  # (s0, bn, flat)
    for (yb0, yb1) in bands:
        s0 = int(cstart[yb0 * m])
        s1 = int(cstart[yb1 * m]) if yb1 < m else n
        bn = s1 - s0
        if bn == 0:
            continue
        bdeg = np.zeros(bn, np.int64)
        offs: list[tuple[np.ndarray, np.ndarray]] = []  # (su_local, v)
        for (dy, dx) in _STENCIL:
            ya0, ya1 = max(yb0, -dy), min(yb1, m - dy)
            xa0, xa1 = max(0, -dx), min(m, m - dx)
            if ya0 >= ya1 or xa0 >= xa1:
                offs.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
                continue
            rows = np.arange(ya0, ya1, dtype=np.int64)
            colsx = np.arange(xa0, xa1, dtype=np.int64)
            a_cells = (rows[:, None] * m + colsx[None, :]).ravel()
            b_cells = a_cells + dy * m + dx
            ac, bc = counts[a_cells], counts[b_cells]
            # candidate enumeration without any vector division: one
            # row per (cell, a-slot), each repeated by the partner
            # cell's occupancy
            R = int(ac.sum())
            if R == 0:
                offs.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
                continue
            acstart = _excl_cumsum(ac)
            rcell = np.repeat(np.arange(len(ac), dtype=np.int64), ac)
            row_ai = np.arange(R, dtype=np.int64) - acstart[rcell]
            su_row = cstart[a_cells][rcell] + row_ai  # strictly increasing
            lens = bc[rcell]
            total = int(lens.sum())
            if total == 0:
                offs.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
                continue
            lstart = _excl_cumsum(lens)
            rrep = np.repeat(np.arange(R, dtype=np.int64), lens)
            w = np.arange(total, dtype=np.int64) - lstart[rrep]
            su = np.repeat(su_row, lens)            # sorted-position of u
            sv = cstart[b_cells][rcell][rrep] + w   # sorted-position of v
            dxv = xs[su] - xs[sv]
            dyv = ys[su] - ys[sv]
            keep = dxv * dxv + dyv * dyv <= r2
            if dy == 0 and dx == 0:
                keep &= su != sv
            su_k = (su[keep] - s0).astype(np.int32)  # band-local row
            v_k = order[sv[keep]].astype(np.int32)   # ascending per run
            bdeg += np.bincount(su_k, minlength=bn)
            offs.append((su_k, v_k))
        # assemble this band's CSR rows while everything is cache-hot:
        # a row's full neighborhood lives in this band, offsets were
        # visited in canonical order, and each row is one contiguous
        # ascending run per offset, so runs land at
        # bstart[row] + cursor[row] + position-within-run
        bstart = _excl_cumsum(bdeg)
        band_flat = np.empty(int(bdeg.sum()), np.int32)
        cursor = np.zeros(bn, np.int64)
        for su_k, v_k in offs:
            if not len(su_k):
                continue
            head = np.ones(len(su_k), bool)
            head[1:] = su_k[1:] != su_k[:-1]
            run_id = np.cumsum(head) - 1
            run_start = np.nonzero(head)[0]
            within = np.arange(len(su_k), dtype=np.int64) - run_start[run_id]
            pos = bstart[su_k] + cursor[su_k] + within
            band_flat[pos] = v_k
            heads = su_k[head]
            run_len = np.diff(np.concatenate([run_start, [len(su_k)]]))
            cursor[heads] += run_len
        deg_sorted[s0:s1] = bdeg
        band_payload.append((s0, bn, band_flat))

    # permute rows from sorted-position order into node-id order,
    # band by band so transients stay band-sized
    degrees = np.empty(n, np.int64)
    degrees[order] = deg_sorted
    nnz = int(deg_sorted.sum())
    nbr_start = _excl_cumsum(degrees)
    nbr_flat = np.empty(nnz, np.int32)
    for s0, bn, band_flat in band_payload:
        deg_b = deg_sorted[s0:s0 + bn]
        bstart = _excl_cumsum(deg_b)
        node_ids = order[s0:s0 + bn]
        pos = (
            np.arange(len(band_flat), dtype=np.int64)
            - np.repeat(bstart[:-1], deg_b)
            + np.repeat(nbr_start[node_ids], deg_b)
        )
        nbr_flat[pos] = band_flat
    return nbr_start[:n + 1], nbr_flat, degrees.astype(np.int32)


def _reference_csr(
    coords: np.ndarray, r: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cKDTree oracle: same pair set as the bucket predicate, reordered
    into the shared canonical (row, stencil offset, node id) layout."""
    from scipy.spatial import cKDTree

    n = len(coords)
    tree = cKDTree(coords)
    pairs = tree.query_pairs(r, output_type="ndarray").astype(np.int64)
    if len(pairs) == 0:
        return np.zeros(n + 1, np.int64), np.zeros(0, np.int32), \
            np.zeros(n, np.int32)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    m = _grid_side(r)
    cx, cy = _bucket_cells(coords, m)
    # neighbors are within r <= cell width, so cells differ by at most 1
    o = (cy[dst] - cy[src] + 1) * 3 + (cx[dst] - cx[src] + 1)
    key = (src * 9 + o) * n + dst
    perm = np.argsort(key, kind="stable")
    degrees = np.bincount(src, minlength=n).astype(np.int32)
    nbr_start = np.zeros(n + 1, np.int64)
    np.cumsum(degrees, out=nbr_start[1:])
    return nbr_start, dst[perm].astype(np.int32), degrees


def random_geometric_graph(
    n: int,
    c: float = 3.0,
    seed: int = 0,
    coords: Optional[np.ndarray] = None,
    radius: Optional[float] = None,
    method: str = "bucket",
    chunk: int = DEFAULT_CHUNK,
) -> Graph:
    """Sample an RGG(n, r(n)) in the unit square (paper §II).

    `method="bucket"` (default) is the streamed cell-bucket builder;
    `method="reference"` is the historical cKDTree path kept as the
    bitwise oracle.  Same (seed, n, c) => identical Graph either way.
    """
    if method not in RGG_METHODS:
        raise ValueError(f"unknown rgg method {method!r}")
    rng = np.random.default_rng(seed)
    if coords is None:
        coords = rng.uniform(0.0, 1.0, size=(n, 2))
    r = connectivity_radius(n, c) if radius is None else float(radius)
    if method == "bucket":
        nbr_start, nbr_flat, degrees = _bucket_csr(coords, r, chunk=chunk)
    else:
        nbr_start, nbr_flat, degrees = _reference_csr(coords, r)
    return Graph(
        coords=coords, nbr_start=nbr_start, nbr_flat=nbr_flat,
        degrees=degrees, radius=r,
    )


def grid_graph(side: int, jitter: float = 0.0, seed: int = 0) -> Graph:
    """sqrt(n) x sqrt(n) lattice embedded in the unit square (paper §VIII)."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    coords = np.stack(
        [(ii.ravel() + 0.5) / side, (jj.ravel() + 0.5) / side], axis=1
    ).astype(np.float64)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        coords = coords + rng.uniform(-jitter, jitter, coords.shape) / side
        coords = np.clip(coords, 0.0, 1.0)
    idx = np.arange(n).reshape(side, side)
    pairs = np.concatenate(
        [
            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1),
        ]
    ).astype(np.int32)
    return Graph.from_pairs(coords, pairs, radius=1.5 / side)


def induced_subgraph(g: Graph, node_ids: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Subgraph induced by node_ids; returns (subgraph, node_ids) with local
    indices 0..len-1 mapping to the original ids (paper Alg. 1 line 14).

    Fully vectorized row packing: gather the flat neighborhoods of
    node_ids, remap to local ids, and compact kept entries — each row
    keeps its original neighbor order (the historical per-row loop's
    layout, asserted by the parity test)."""
    node_ids = np.asarray(node_ids, np.int32)
    ids64 = node_ids.astype(np.int64)
    remap = np.full(g.n, -1, np.int32)
    remap[ids64] = np.arange(len(node_ids), dtype=np.int32)
    deg = g.degrees[ids64].astype(np.int64)
    total = int(deg.sum())
    new_start = np.zeros(len(node_ids) + 1, np.int64)
    np.cumsum(deg, out=new_start[1:])
    pos = (
        np.arange(total, dtype=np.int64)
        - np.repeat(new_start[:-1], deg)
        + np.repeat(g.nbr_start[ids64], deg)
    )
    mapped = remap[g.nbr_flat[pos]]
    keep = mapped >= 0
    src_local = np.repeat(
        np.arange(len(node_ids), dtype=np.int64), deg
    )[keep]
    degrees = np.bincount(
        src_local, minlength=len(node_ids)
    ).astype(np.int32)
    nbr_start = np.zeros(len(node_ids) + 1, np.int64)
    np.cumsum(degrees, out=nbr_start[1:])
    return (
        Graph(
            coords=g.coords[ids64],
            nbr_start=nbr_start,
            nbr_flat=mapped[keep],
            degrees=degrees,
            radius=g.radius,
        ),
        node_ids,
    )


def _component_labels(g: Graph) -> np.ndarray:
    """Connected-component label per node via scipy.sparse.csgraph —
    the historical pure-python BFS was O(n) interpreter steps and took
    seconds at n=10^5."""
    if g.n == 0:
        return np.zeros(0, np.int32)
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    adj = sp.csr_matrix(
        (
            np.ones(g.nnz, np.int8),
            g.nbr_flat.astype(np.int64),
            g.nbr_start,
        ),
        shape=(g.n, g.n),
    )
    _, labels = connected_components(adj, directed=False)
    return labels.astype(np.int32)


def _num_components(g: Graph) -> int:
    return int(_component_labels(g).max()) + 1 if g.n else 0
