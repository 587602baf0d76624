"""Synchronous multiscale gossip — the batched-mixing fast path.

Each level's gossip runs as synchronous rounds of doubly-stochastic
mixing,

    x_cells <- W_cells^R @ x_cells      (all cells batched),

through the `cell_mixing` kernel.  Expected-value equivalence with
asynchronous pairwise gossip is standard (Boyd et al.); message
accounting per synchronous round is 2 transmissions per base edge (or
2*hops per overlay edge).

Topology, routing and promotion come from the shared
`core.plan.HierarchyPlan` (rep_mode="first": deterministic election), so
this path and the asynchronous engine execute the same hierarchy.  Node
values may be d-dimensional.  State stays on the device; the
convergence check syncs once per chunk of rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .options import resolve_device
from .plan import HierarchyPlan, build_plan
from .rgg import Graph

__all__ = ["SyncMultiscaleResult", "synchronous_multiscale"]


@dataclasses.dataclass
class SyncMultiscaleResult:
    x_final: np.ndarray     # (n, d)
    messages: int
    rounds_per_level: list[tuple[int, int]]  # (level, rounds)

    def error(self, x0: np.ndarray) -> float:
        avg = x0.mean(axis=0, keepdims=True)
        return float(
            np.linalg.norm(self.x_final - avg) / max(np.linalg.norm(x0), 1e-30)
        )


def _mix_until(w, x, mask, eps, max_rounds, chunk):
    """Apply W repeatedly (chunked) until every cell is within eps of its
    mean. Returns (x, rounds)."""
    from ..kernels.cell_mixing import cell_mixing

    live = mask[..., None].to(torch.float32)
    mean = (x * live).sum(1, keepdim=True) / torch.clamp_min(
        live.sum(1, keepdim=True), 1.0)
    tol = eps * torch.clamp_min(
        torch.sqrt(((x * live) ** 2).sum((1, 2))), 1e-30)
    rounds = 0
    cur = x
    while rounds < max_rounds:
        err = torch.sqrt((((cur - mean) * live) ** 2).sum((1, 2)))
        if bool((err <= tol).all()):
            break
        cur = cell_mixing(w, cur, rounds=chunk)
        rounds += chunk
    return cur, rounds


def _level_exchange_cost(lp) -> int:
    """Single-hop transmissions per synchronous round at this level:
    2 per base edge, 2*hops per overlay edge."""
    if lp.kind == "cells":
        return int(lp.degrees.sum())  # = 2 * #edges
    hops = lp.hop_flat[lp.edge_pos_i]
    return int(2 * hops.sum())


def synchronous_multiscale(
    g: Graph,
    x0: np.ndarray,
    *,
    eps: float = 1e-4,
    k: Optional[int] = None,
    a: float = 2.0 / 3.0,
    cell_max: float = 8.0,
    chunk: int = 8,
    max_rounds: int = 4096,
    device: str = "cuda",
    plan: Optional[HierarchyPlan] = None,
) -> SyncMultiscaleResult:
    """Weighted (exact-mass) multiscale averaging with synchronous mixing.

    x0 may be (n,) scalars or (n, d) vectors.  On the card the mixing
    runs in the `cell_mixing` kernel; ``device="cpu"`` runs its plain
    version.
    """
    from ..kernels.cell_mixing import mixing_matrix

    dev = resolve_device(device)
    x0 = np.asarray(x0, np.float32)
    if x0.ndim == 1:
        x0 = x0[:, None]
    n, d = x0.shape
    if plan is None:
        plan = build_plan(g, k=k, a=a, cell_max=cell_max, rep_mode="first")
    messages = 0
    rounds_log = []

    xb = None
    for li, lp in enumerate(plan.levels):
        B, C = lp.node_mask.shape
        if lp.kind == "cells":
            # channels: [w*x (d), w] for exact-mass fusion
            host = np.zeros((B, C, d + 1), np.float32)
            live = lp.node_mask
            host[..., :d][live] = x0[lp.slot_node[live]]
            host[..., d][live] = 1.0
            xb = torch.as_tensor(host, device=dev)
        w = torch.as_tensor(
            mixing_matrix(lp.neighbors, lp.degrees, lp.n_nodes), device=dev)
        mask = torch.as_tensor(lp.node_mask, device=dev)
        xb, rounds = _mix_until(w, xb, mask, eps, max_rounds, chunk)
        messages += _level_exchange_cost(lp) * rounds
        rounds_log.append((lp.level, rounds))
        if lp.rep_slot is not None:
            # promote the representative's total cell mass to the parent grid
            rep = xb[torch.arange(B, device=dev),
                     torch.as_tensor(lp.rep_slot, device=dev).long()]
            rep = rep * torch.as_tensor(
                lp.n_nodes, device=dev)[:, None].to(torch.float32)
            B2, C2 = plan.levels[li + 1].node_mask.shape
            nxt = torch.zeros((B2, C2, d + 1), dtype=torch.float32,
                              device=dev)
            nxt[torch.as_tensor(lp.next_graph, device=dev).long(),
                torch.as_tensor(lp.next_slot, device=dev).long()] = rep
            xb = nxt

    est = xb[..., :d] / torch.clamp_min(xb[..., d:], 1e-30)
    x_final = est[torch.as_tensor(plan.final_graph, device=dev).long(),
                  torch.as_tensor(plan.final_slot, device=dev).long()]
    if plan.disseminate:
        messages += n
    return SyncMultiscaleResult(
        x_final=x_final.cpu().numpy(), messages=messages,
        rounds_per_level=rounds_log,
    )
