"""Randomized pairwise gossip (Boyd et al. [2]) — the black box used by
multiscale gossip (paper §III, Alg. 1 lines 9/15).

B independent graphs (all cells of one hierarchy level) gossip in
lockstep, each with its own convergence flag.  At each tick a uniformly
random node of each not-yet-converged graph wakes, picks a uniformly
random neighbor, and the pair averages.  Messages are counted per
directed edge, so multi-hop overlay costs and per-node attribution can
be computed afterwards.  Values carry V channels (V=2 is the
mass-weighted variant, where (w*x, w) pairs are averaged).

Optional per-hop message loss (paper §VI-C-2): each single-hop
transmission succeeds w.p. `loss_p`; a lost request aborts the exchange,
a lost reply leaves only the contacted node updated.

Schedule / value split: every exchange decision depends only on
``(key, t)``, so each ``check_every`` chunk first presamples its
``(T, B)`` schedule and counts its usage and messages
(`kernels.sample_chunk`: on the card one CUDA kernel, bitwise equal to
its plain version around `core.schedule.sample_schedule`, which backend
``"ref"`` runs), then applies the pair list with the chosen value
backend (`core.options`):

* ``"ref"`` — `kernels.pair_apply.pair_apply_ref`, the plain tick loop;
* ``"cuda"`` — the `pair_apply` CUDA kernel, bitwise equal to ``"ref"``;
* ``"matmul"`` — `compose_schedule` then the `cell_mixing` kernel
  (values agree up to f32 rounding; integer accounting is exact).

``schedule="per_tick"`` keeps the reference's legacy sequential path,
the parity reference: each tick is drawn (`schedule.sample_tick`),
counted and applied before the next is drawn.  Backend ``"ref"`` applies
each tick to the state (the reference's ``"lax"`` scan); backend
``"cuda"`` is the reference's ``"pallas"`` branch: the ticks are applied
to the rows of an identity ``(N, C, C)``, built once a call, and the
chunk's mixing matrix goes through one `cell_mixing` kernel launch
(values agree up to f32 rounding).  Backend ``"matmul"``, failure
scenarios and cost pricing need the presampled schedule.

The reference's ``lax.while_loop`` is a host loop over chunks here.  In
fixed-iterations mode (``eps < 0``: the oracle never fires) its trip
count is known on the host, so the loop never waits for the device; in
eps mode the ``done`` check syncs once per chunk.

Failure scenarios and pricing (`core.medium`): a `FailureCtx` perturbs
each drawn chunk before the value pass — down initiators never wake,
down partners waste the forward leg, straggler exchanges fail on a
tagged uniform stream, Byzantine slots drop their updates — and a
`CostModel` adds the chunk's sampled retransmissions (a second tagged
stream) and its concurrency pairs.  Both live in the chunk draw, so a
scenario or priced chunk is still one `sample_chunk` launch.

Node sharding (``node_shard=(cols, ok)``): a rank of the engine's
``("trials", "nodes")`` mesh owns columns `cols` of the level's global
batch (clipped duplicates masked by `ok`); `x0` and `node_mask` are
its ``(R, Bs, ...)`` slices.  The draw stays global, as in the
reference: threefry streams have no prefix property, so a local draw
would diverge from the unsharded run.  The foreign columns enter the
draw as done, so it counts nothing for them, and its ``(T, R*B)``
schedule is sliced to the owned columns for the value pass; per-graph
results are bitwise those of the unsharded run.  Each rank's eps-mode
loop stops when its own graphs have converged.

Monte-Carlo trials are a batch axis written out: ``x0`` is
``(R, B, C, V)`` and ``keys`` ``(R, 2)``, one key per trial over the same
graphs.  The trials fold into the graph batch of the value pass, so one
kernel launch per chunk serves all of them.  A trial whose graphs have
all converged keeps running as an identity (every exchange is masked),
which is what the reference's per-trial loop gives.

Shapes:
  x0        : (R, B, C, V)   node values, padded with 0
  adj       : CsrGraphs      int32 tensors on the device
  node_mask : (B, C)         live-node mask
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import prng
from .medium import CostModel, FailureCtx
from .options import resolve_device
from .schedule import (
    CsrGraphs,
    compose_schedule,
    dense_to_csr,
    flat_usage_to_dense,
    sample_tick,
)

__all__ = ["GossipResult", "gossip_core", "gossip_until", "batched_graphs",
           "GOSSIP_BACKENDS"]

GOSSIP_BACKENDS = ("ref", "cuda", "matmul")


@dataclasses.dataclass
class GossipResult:
    x: np.ndarray            # (B, C, V) final values
    ticks: np.ndarray        # (B,) exchanges attempted per graph
    converged: np.ndarray    # (B,) bool
    edge_usage: np.ndarray   # (B, C, D) int32: #exchanges initiated i->j
    messages: np.ndarray     # (B,) total single-hop transmissions

    @property
    def total_messages(self) -> int:
        return int(self.messages.sum())

    def estimates(self) -> np.ndarray:
        """(B, C) per-node estimates (ratio of channels if V == 2)."""
        if self.x.shape[-1] == 1:
            return self.x[..., 0]
        return self.x[..., 0] / np.maximum(self.x[..., 1], 1e-30)


def _value_pass(backend, x, i, j, upd_i, upd_j):
    """Apply one chunk's (T, N) pair list to (N, C, V) state."""
    if backend == "ref":
        from ..kernels.pair_apply import pair_apply_ref

        return pair_apply_ref(x, i, j, upd_i, upd_j)
    if backend == "cuda":
        from ..kernels.pair_apply import pair_apply

        return pair_apply(x, i, j, upd_i, upd_j)
    from ..kernels.cell_mixing import cell_mixing

    m = compose_schedule(x.shape[1], i, j, upd_i, upd_j, x.dtype)
    return cell_mixing(m, x, rounds=1)


def _one_tick(x, t, keys, adj: CsrGraphs, loss_p, done, usage, msgs):
    """The legacy tick: draw tick `t` for R trials of B graphs, count it
    (usage and messages grow in place) and apply it to the ``(R*B, C,
    V)`` state, as the reference's `_one_tick`.  The draw is the one
    `sample_schedule` makes for the same tick, so the two schedules stay
    draw for draw identical."""
    from ..kernels.pair_apply import pair_apply_ref

    R, B = done.shape
    s = sample_tick(t, keys, adj, loss_p)               # (R, B) fields
    active = s.valid & ~done                            # done frozen
    upd_j = active & s.fwd_ok
    upd_i = upd_j & s.rep_ok
    offs = (torch.arange(R, device=keys.device, dtype=torch.int32)
            * adj.nbr.shape[0])[:, None]
    usage.index_add_(0, (s.pos + offs).reshape(-1),
                     active.to(torch.int32).reshape(-1))
    msgs += torch.where(active, s.cost, 0)
    return pair_apply_ref(x, s.i.reshape(1, -1), s.j.reshape(1, -1),
                          upd_i.reshape(1, -1), upd_j.reshape(1, -1))


def _per_tick_chunk(x, eye, t0: int, T: int, keys, adj, loss_p, done,
                    usage, msgs):
    """Ticks ``t0 .. t0+T-1`` one after another.  Without `eye` each
    tick is applied to the state; with it (backend "cuda") the ticks
    build the chunk's mixing matrix from the identity's rows and one
    `cell_mixing` launch applies it."""
    ts = torch.arange(t0, t0 + T, device=keys.device)
    m = x if eye is None else eye.clone()
    for k in range(T):
        m = _one_tick(m, ts[k], keys, adj, loss_p, done, usage, msgs)
    if eye is None:
        return m
    from ..kernels.cell_mixing import cell_mixing

    return cell_mixing(m, x, rounds=1)


def gossip_core(
    x0: torch.Tensor,
    adj: CsrGraphs,
    node_mask: torch.Tensor,
    eps: float,
    keys: torch.Tensor,
    *,
    max_ticks: int,
    check_every: int,
    loss_p: Optional[float],
    backend: str = "cuda",
    schedule: str = "presampled",
    failure_ctx: Optional[FailureCtx] = None,
    cost_model: Optional[CostModel] = None,
    hop_cap: int = 1,
    node_shard=None,
):
    """Batched gossip loop over R trials of the same B graphs.

    Returns (x, usage, msgs, done, ticks): x ``(R, B, C, V)``, usage the
    flat ``(R, nnz+1)`` int32 per-directed-edge counters aligned with
    `adj`, msgs / ticks ``(R, B)`` int32 and done ``(R, B)`` bool.  The
    exchange sequence, usage and message counts do not depend on the
    backend.  With `cost_model` two ``(R, B)`` counters follow:
    retransmissions (int32, sampled extra attempts) and congestion pairs
    (f32); they never change the others.  `failure_ctx` perturbs the
    schedule (module docstring); `hop_cap` is the level's longest route
    in hops, the width of the retransmission draw.  `schedule` is
    "presampled" or "per_tick" (module docstring).

    `node_shard=(cols, ok)` runs only the global batch columns `cols`
    (int64, ``(Bs,)``) with realness mask `ok` (module docstring): x,
    msgs, done and ticks are the ``Bs`` local columns, usage stays
    global-flat with only the owned graphs' exchanges counted.
    """
    if backend not in GOSSIP_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if schedule not in ("presampled", "per_tick"):
        raise ValueError(f"unknown schedule mode {schedule!r}")
    per_tick = schedule == "per_tick"
    if per_tick and backend == "matmul":
        raise ValueError("backend='matmul' requires schedule='presampled'")
    if per_tick and (failure_ctx is not None or cost_model is not None):
        raise ValueError(
            "failure scenarios / cost pricing require "
            "schedule='presampled'")
    if node_shard is not None and (per_tick or failure_ctx is not None
                                   or cost_model is not None):
        raise ValueError(
            "node_shard requires schedule='presampled' and takes no failure "
            "scenario or cost model")
    if backend == "ref":
        from ..kernels.sample_chunk import sample_chunk_ref as draw
    else:
        from ..kernels.sample_chunk import sample_chunk as draw
    R, B, C, V = x0.shape
    dev = x0.device
    live = node_mask.to(x0.dtype)[None, :, :, None]      # (1, B, C, 1)
    fixed = eps < 0  # negative tol: the oracle never fires
    if not fixed:
        denom = torch.clamp_min(live.sum(2), 1.0)
        mean = (x0 * live).sum(2) / denom                   # (R, B, V)
        x0_norm = torch.sqrt(((x0 * live) ** 2).sum((2, 3)))
        tol = eps * torch.clamp_min(x0_norm, 1e-30)

        def converged(x):
            d = (x - mean[:, :, None, :]) * live
            return torch.sqrt((d ** 2).sum((2, 3))) <= tol

    nflat = adj.nbr.shape[0]
    usage = torch.zeros(R * nflat, dtype=torch.int32, device=dev)
    Bg = adj.degrees.shape[0]  # the global batch (B unless node-sharded)
    msgs = torch.zeros((R, Bg), dtype=torch.int32, device=dev)
    ticks = torch.zeros((R, B), dtype=torch.int32, device=dev)
    done = (converged(x0) if not fixed
            else torch.zeros((R, B), dtype=torch.bool, device=dev))
    if node_shard is not None:
        cols, ok = node_shard
        own = cols[ok]
        done_g = torch.ones((R, Bg), dtype=torch.bool, device=dev)
    extra = {}
    if cost_model is not None:
        extra = dict(
            retx=torch.zeros((R, B), dtype=torch.int32, device=dev),
            congp=torch.zeros((R, B), dtype=torch.float32, device=dev))
    x = x0.reshape(R * B, C, V)
    # the per-tick "cuda" branch's identity seed, built once a call
    eye = (torch.eye(C, dtype=x.dtype, device=dev).expand(R * B, C, C)
           if per_tick and backend == "cuda" else None)
    t0 = 0
    while t0 < max_ticks:
        if not fixed and bool(done.all()):
            break
        if per_tick:
            x = _per_tick_chunk(x, eye, t0, check_every, keys, adj, loss_p,
                                done, usage, msgs)
        elif node_shard is not None:
            done_g[:, own] = done[:, ok]
            i, j, upd_i, upd_j = (
                a.view(check_every, R, Bg)[:, :, cols].reshape(
                    check_every, R * B)
                for a in draw(t0, check_every, keys, adj, loss_p, done_g,
                              usage, msgs))
            keep = ok.repeat(R)
            x = _value_pass(backend, x, i, j, upd_i & keep, upd_j & keep)
        else:
            # (T, R*B) pairs and update bits; the counters grow in place
            x = _value_pass(backend, x, *draw(
                t0, check_every, keys, adj, loss_p, done, usage, msgs,
                failure_ctx=failure_ctx, cost=cost_model, hop_cap=hop_cap,
                **extra))
        ticks += torch.where(done, 0, check_every).to(torch.int32)
        if not fixed:
            done = done | converged(x.reshape(R, B, C, V))
        t0 += check_every
    if node_shard is not None:
        msgs = torch.where(ok, msgs[:, cols], 0)
    return (x.reshape(R, B, C, V), usage.reshape(R, nflat), msgs, done,
            ticks, *extra.values())


def gossip_until(
    x0: np.ndarray,
    neighbors: np.ndarray,
    degrees: np.ndarray,
    n_nodes: np.ndarray,
    *,
    eps: float,
    seed: int = 0,
    edge_hops: Optional[np.ndarray] = None,
    node_mask: Optional[np.ndarray] = None,
    max_ticks: int = 2_000_000,
    check_every: int = 64,
    fixed_ticks: Optional[int] = None,
    loss_p: Optional[float] = None,
    backend: str = "cuda",
    schedule: str = "presampled",
    device: str = "cuda",
) -> GossipResult:
    """Run batched randomized gossip to eps-accuracy (or `fixed_ticks`).

    `fixed_ticks` is the paper's fixed-iterations variant
    (MultiscaleGossipFI, §VI): that many exchanges per graph, rounded up
    to whole chunks, no convergence oracle.  `backend` and `schedule`
    select the value pass and the execution mode (module docstring).
    The host API stays dense — ``(B, C, D)`` padded neighbors in, dense
    `edge_usage` out.
    """
    dev = resolve_device(device)
    if backend == "cuda" and dev.type == "cpu":
        raise ValueError("backend='cuda' needs device='cuda'")
    x0 = np.asarray(x0)
    if x0.ndim == 2:
        x0 = x0[..., None]
    B, C, V = x0.shape
    D = neighbors.shape[2]
    if node_mask is None:
        node_mask = np.arange(C)[None, :] < np.asarray(n_nodes)[:, None]
    adj = dense_to_csr(neighbors, degrees, n_nodes, edge_hops).to_device(dev)
    if fixed_ticks is not None:
        eps_eff = -1.0
        check = max(1, min(check_every, int(fixed_ticks)))
        max_t = ((int(fixed_ticks) + check - 1) // check) * check
    else:
        eps_eff, max_t, check = float(eps), int(max_ticks), int(check_every)
    x, usage, msgs, done, ticks = gossip_core(
        torch.as_tensor(np.asarray(x0, np.float32), device=dev)[None],
        adj,
        torch.as_tensor(np.asarray(node_mask, bool), device=dev),
        eps_eff,
        prng.PRNGKey(seed, dev)[None],
        max_ticks=max_t, check_every=check, loss_p=loss_p, backend=backend,
        schedule=schedule,
    )
    return GossipResult(
        x=x[0].cpu().numpy(),
        ticks=ticks[0].cpu().numpy(),
        converged=done[0].cpu().numpy(),
        edge_usage=flat_usage_to_dense(usage[0].cpu().numpy(), degrees, D),
        messages=msgs[0].cpu().numpy(),
    )


def batched_graphs(
    graphs: list,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a list of `rgg.Graph`-like (neighbors, degrees) into batch form.

    Returns (neighbors (B,C,D), degrees (B,C), n_nodes (B,), node_mask).
    """
    B = len(graphs)
    C = max(1, max(g.n for g in graphs))
    D = max(1, max(g.max_deg for g in graphs))
    neighbors = np.full((B, C, D), -1, np.int32)
    degrees = np.zeros((B, C), np.int32)
    n_nodes = np.zeros((B,), np.int32)
    for b, g in enumerate(graphs):
        neighbors[b, : g.n, : g.max_deg] = g.neighbors
        degrees[b, : g.n] = g.degrees
        n_nodes[b] = g.n
    node_mask = np.arange(C)[None, :] < n_nodes[:, None]
    return neighbors, degrees, n_nodes, node_mask
