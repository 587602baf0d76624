"""Presampled exchange schedules for randomized gossip.

Every exchange decision of the asynchronous gossip model — which node
wakes, which neighbor it draws, whether each hop of the request/reply
survives, what the exchange costs — depends only on ``(key, t)``, never
on the node values; only the pair-average recursion itself is
sequential.  This module holds the sampling half:

* `sample_tick` draws one tick for all B graphs of a level, with the
  reference's RNG consumption order (fold the tick into the key, split
  four ways, draw the waking node, the neighbor slot and the two hop
  outcomes), through the bit-exact threefry of `core.prng`;
* `sample_schedule` draws a whole ``check_every`` chunk at once by
  giving `sample_tick` a batch of tick indices;
* `compose_schedule` folds a presampled pair list into the chunk's
  ``(B, C, C)`` mixing matrix with a log2(T) tree of batched matmuls
  (f32, TF32 off).  Matrix composition reassociates the sums, so values
  through it agree with the sequential recursion only up to f32 rounding.

Keys may carry a leading batch (Monte-Carlo trials): a key of shape
``(*K, 2)`` gives schedule fields of shape ``(*K, B)`` per tick and
``(T, *K, B)`` per chunk.

Adjacency is CSR (`CsrGraphs`): one flat entry per directed edge plus a
single trailing sentinel, so usage counters live in a flat ``(nnz+1,)``
buffer and a sampled tick carries `pos`, the flat index of its edge.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import prng

__all__ = [
    "CsrGraphs",
    "ExchangeSchedule",
    "dense_to_csr",
    "flat_usage_to_dense",
    "truncated_failure_hops",
    "sample_tick",
    "sample_schedule",
    "compose_schedule",
]


class CsrGraphs(NamedTuple):
    """CSR adjacency for a batch of B padded graphs.

    Row ``(b, c)`` owns flat entries ``start[b, c] : start[b, c] +
    degrees[b, c]``.  One trailing sentinel entry (``nbr=0, hops=1``)
    keeps the flat arrays non-empty and gives empty rows an in-bounds
    gather target — a draw against a zero-degree row is already marked
    invalid by the schedule, so the garbage neighbor is never applied.
    Fields are numpy arrays on the host (`dense_to_csr`) or int32
    tensors on the device (`to_device`).
    """

    start: object    # (B, C) int32 flat offset of each row
    nbr: object      # (nnz+1,) int32 neighbor slot within the graph
    hops: object     # (nnz+1,) int32 per-edge routing hops
    degrees: object  # (B, C) int32
    n_nodes: object  # (B,) int32

    def to_device(self, device) -> "CsrGraphs":
        return CsrGraphs(*(
            torch.as_tensor(np.asarray(a, np.int32), device=device)
            for a in self))


def dense_to_csr(neighbors, degrees, n_nodes, edge_hops=None) -> CsrGraphs:
    """Pack ``(B, C, D)`` padded adjacency into a host-side `CsrGraphs`.

    Entry order within a row is the dense row order (slots < degree), so
    a jidx drawn uniformly in [0, deg) addresses the same neighbor in
    both layouts.
    """
    neighbors = np.asarray(neighbors)
    degrees = np.asarray(degrees, np.int32)
    B, C, D = neighbors.shape
    if edge_hops is None:
        edge_hops = np.ones((B, C, D), np.int32)
    keep = np.arange(D)[None, None, :] < degrees[:, :, None]
    cs = np.concatenate([[0], np.cumsum(degrees.ravel(), dtype=np.int64)])
    start = cs[:-1].reshape(B, C).astype(np.int32)
    nbr = np.concatenate([neighbors[keep].astype(np.int32), [0]])
    hops = np.concatenate([np.asarray(edge_hops)[keep].astype(np.int32), [1]])
    return CsrGraphs(
        start=start, nbr=nbr, hops=hops, degrees=degrees,
        n_nodes=np.asarray(n_nodes, np.int32),
    )


def flat_usage_to_dense(usage, degrees, D=None) -> np.ndarray:
    """Scatter flat ``(nnz+1,)`` usage counters back to ``(B, C, D)``.

    The host-side inverse of the CSR layout; padding slots get 0, the
    sentinel entry is dropped.
    """
    usage = np.asarray(usage)
    degrees = np.asarray(degrees, np.int64)
    B, C = degrees.shape
    if D is None:
        D = max(1, int(degrees.max(initial=0)))
    nnz = int(degrees.sum())
    deg_flat = degrees.ravel()
    row = np.repeat(np.arange(B * C), deg_flat)
    col = np.arange(nnz) - np.repeat(
        np.concatenate([[0], np.cumsum(deg_flat)])[:-1], deg_flat
    )
    out = np.zeros((B * C, D), usage.dtype)
    out[row, col] = usage[:nnz]
    return out.reshape(B, C, D)


class ExchangeSchedule(NamedTuple):
    """Value-independent draws for a block of gossip ticks.

    All fields end in the graph axis B.  `valid` excludes the per-chunk
    `done` freeze, which is the caller's to apply: ``active = valid &
    ~done``.
    """

    i: torch.Tensor       # int32 waking node
    jidx: torch.Tensor    # int32 neighbor slot drawn at i
    j: torch.Tensor       # int32 contacted node (garbage when not `valid`)
    valid: torch.Tensor   # bool: i has neighbors
    fwd_ok: torch.Tensor  # bool: request delivered over every hop
    rep_ok: torch.Tensor  # bool: reply delivered over every hop
    cost: torch.Tensor    # int32 single-hop transmissions if the tick is active
    pos: torch.Tensor     # int32 flat CSR index of the drawn directed edge


def truncated_failure_hops(u, p: float, h):
    """Hops transmitted for a message over h hops with per-hop success p.

    Successes before the first failure: S = floor(log u / log p);
    delivered iff S >= h (transmits h), else transmits S + 1.  Returns
    (delivered, hops_transmitted).  `u` is float32, `h` int32.
    """
    pf = torch.tensor(p, dtype=torch.float32, device=u.device)
    if p < 1.0:
        log_p = torch.log(torch.clamp_min(pf, 1e-12))
        s = torch.floor(torch.log(u) / log_p)
    else:
        s = torch.full_like(u, float("inf"))
    delivered = s >= h
    return delivered, torch.where(delivered, h.to(s.dtype), s + 1.0).to(
        torch.int32)


def sample_tick(t, key, adj: CsrGraphs,
                loss_p: Optional[float]) -> ExchangeSchedule:
    """Draw one tick's exchange decisions for all B graphs.

    `key` is ``(*K, 2)`` and `t` an int or an int tensor broadcasting
    against ``K``; fields come out as ``(*broadcast, B)``.  The draws are
    over the full batch, as in the reference.
    """
    B, C = adj.degrees.shape
    bidx = torch.arange(B, device=adj.degrees.device)

    def uniform(k):
        return prng.uniform(k, (B,))

    kt = prng.fold_in(key, t)
    ki, kj, kf, kr = prng.split(kt, 4).unbind(-2)
    # pick a waking node per graph (uniform over live nodes)
    u = uniform(ki)
    i = torch.minimum((u * adj.n_nodes).to(torch.int32), adj.n_nodes - 1)
    deg_i = adj.degrees[bidx, i.long()]
    v = uniform(kj)
    jidx = torch.minimum((v * deg_i).to(torch.int32),
                         torch.clamp_min(deg_i - 1, 0))
    pos = adj.start[bidx, i.long()] + jidx
    j = adj.nbr[pos.long()]
    valid = deg_i > 0  # compact rows: deg>0 iff the slot holds a real edge
    hops = adj.hops[pos.long()]

    if loss_p is None:
        fwd_ok = torch.ones_like(valid)
        rep_ok = torch.ones_like(valid)
        cost = 2 * hops
    else:
        fwd_ok, fwd_hops = truncated_failure_hops(
            uniform(kf), loss_p, hops)
        rep_ok, rep_hops = truncated_failure_hops(
            uniform(kr), loss_p, hops)
        cost = fwd_hops + torch.where(fwd_ok, rep_hops, 0)
    return ExchangeSchedule(
        i=i, jidx=jidx, j=j, valid=valid,
        fwd_ok=fwd_ok, rep_ok=rep_ok, cost=cost, pos=pos,
    )


def sample_schedule(ts, key, adj: CsrGraphs,
                    loss_p: Optional[float]) -> ExchangeSchedule:
    """Presample a whole chunk: `sample_tick` over the tick indices `ts`
    at once, giving fields of shape ``(len(ts), *K, B)``."""
    ts = torch.as_tensor(ts, dtype=torch.int64, device=key.device)
    return sample_tick(ts.reshape(-1, *([1] * (key.dim() - 1))), key, adj,
                       loss_p)


def compose_schedule(num_slots: int, i, j, upd_i, upd_j,
                     dtype=torch.float32) -> torch.Tensor:
    """Compose a presampled ``(T, B)`` pair list into one ``(B, C, C)``
    mixing matrix.

    Tick t's elementary matrix E_t is the identity with rows i_t / j_t
    replaced by the pair average 0.5 (e_i + e_j) where the respective
    update fires (partner row written first, then initiator, as in the
    tick loop).  The chunk matrix E_T @ … @ E_1 is folded with a log2(T)
    tree of batched matmuls in full f32 (TF32 off).  Materializes
    ``(T, B, C, C)``: meant for the small per-cell matrices of the
    hierarchy.
    """
    from .._tf32 import no_tf32

    T, B = i.shape
    C = num_slots
    dev = i.device
    eye = torch.eye(C, dtype=dtype, device=dev)
    e_i = eye[i.long()]                    # (T, B, C) one-hot rows
    e_j = eye[j.long()]
    avg = 0.5 * (e_i + e_j)
    rows_i = torch.where(upd_i[..., None], avg, e_i)
    rows_j = torch.where(upd_j[..., None], avg, e_j)
    tidx = torch.arange(T, device=dev)[:, None]
    bidx = torch.arange(B, device=dev)[None, :]
    E = eye.expand(T, B, C, C).clone()
    E[tidx, bidx, j.long()] = rows_j
    E[tidx, bidx, i.long()] = rows_i
    P = 1 << max(T - 1, 0).bit_length()
    if P != T:
        E = torch.cat([E, eye.expand(P - T, B, C, C)], 0)
    with no_tf32():
        while E.shape[0] > 1:
            # fold adjacent pairs: the later tick multiplies from the left
            E = torch.matmul(E[1::2], E[0::2])
    return E[0]
