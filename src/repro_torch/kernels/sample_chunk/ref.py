"""Plain PyTorch version of the sample_chunk kernel: one gossip chunk's
exchange schedule and its accounting, as `gossip_core` computed them
around `core.schedule.sample_schedule`.

It draws the chunk with the bit-exact threefry of `core.prng` as eager
tensor ops (hundreds of launches a chunk on the card), folds the ``done``
freeze and the hop outcomes into the update bits, and counts usage with
one scatter-add and messages with one reduction.  With a failure
scenario it perturbs the drawn schedule as the reference's chunk body
does (`src/repro/core/gossip.py:282-312`): down nodes, a tagged
straggler stream, Byzantine slots that drop their updates.  With a cost
model it also counts the chunk's sampled retransmissions (a second
tagged stream) and its concurrency pairs (`gossip.py:314-330`).  It is
the ``"ref"`` engine backend's draw and the yardstick the CUDA kernel is
held against bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import prng
from ...core.medium import (
    _TAG_RETX,
    _TAG_STRAGGLER,
    BYZ,
    CHURNED,
    REGIONAL,
    STRAGGLER,
    CostModel,
    FailureCtx,
)
from ...core.schedule import CsrGraphs, sample_schedule

__all__ = ["sample_chunk_ref", "log_q", "cost_streams"]


def log_q(retransmit_p: float) -> float:
    """``log q`` of the retransmission count ``floor(log u / log q)``,
    ``q = 1 - retransmit_p``: an f32 log of the f32 rounding of q, taken
    once on the host so that the kernel and this version divide by the
    same number."""
    q = torch.tensor(1.0 - retransmit_p, dtype=torch.float32)
    return float(torch.log(q))


def cost_streams(cost: Optional[CostModel]) -> tuple[bool, bool]:
    """(sample_retx, track_congestion) of a cost model: the two
    reductions a chunk adds for it."""
    if cost is None:
        return False, False
    return (cost.sample and cost.retransmit_p < 1.0,
            cost.congestion_alpha > 0.0)


def sample_chunk_ref(t0: int, T: int, keys, adj: CsrGraphs,
                     loss_p: Optional[float], done, usage, msgs,
                     failure_ctx: Optional[FailureCtx] = None,
                     cost: Optional[CostModel] = None, hop_cap: int = 1,
                     retx=None, congp=None):
    """Draw ticks ``t0 .. t0+T-1`` for R trials of the same B graphs.

    Args:
      keys: (R, 2) int64 level keys, one a trial.
      adj: `CsrGraphs` of int32 tensors; ``nflat = adj.nbr.shape[0]``.
      loss_p: per-hop success probability, or None for no loss.
      done: (R, B) bool, graphs frozen for the whole chunk.
      usage: (R*nflat,) int32 flat per-edge exchange counters; the
        chunk's attempted exchanges are added in place.
      msgs: (R, B) int32 single-hop transmissions; the chunk's are added
        in place.
      failure_ctx: the level's scenario (`core.medium.FailureCtx`), or
        None.  Ticks compare with its windows as ``t0 + t``.
      cost: a `CostModel`, or None.  When it samples retransmissions
        (``sample`` and ``retransmit_p < 1``) the chunk's extra attempts
        are added into `retx`, (R, B) int32; when it prices congestion
        (``congestion_alpha > 0``) the chunk's concurrency pairs are
        summed in int32 and added into `congp`, (R, B) f32.
      hop_cap: the level's longest route in hops (at least 1): each
        exchange draws ``2 * hop_cap`` retransmission words.
    Returns (i, j, upd_i, upd_j), each (T, R*B): int32 pairs and bool
    update bits, the value pass's input.
    """
    R, B = done.shape
    nflat = adj.nbr.shape[0]
    dev = keys.device
    ts = torch.arange(t0, t0 + T, device=dev)
    s = sample_schedule(ts, keys, adj, loss_p)  # (T, R, B)
    active = s.valid & ~done                            # done frozen
    if failure_ctx is None:
        attempt = active
        cost_t = s.cost
        upd_j = active & s.fwd_ok
        upd_i = upd_j & s.rep_ok
    else:
        fc = failure_ctx
        bidx = torch.arange(B, device=dev)
        bits_i = fc.bits[bidx, s.i.long()]
        bits_j = fc.bits[bidx, s.j.long()]
        when = ts[:, None, None]
        churn_now = when >= fc.churn_tick
        reg_now = (when >= fc.reg_t0) & (when < fc.reg_t1)

        def down(bits):
            return (((bits & CHURNED) != 0) & churn_now) | (
                ((bits & REGIONAL) != 0) & reg_now)

        down_i, down_j = down(bits_i), down(bits_j)
        attempt = active & ~down_i          # a down initiator never wakes
        delivered = attempt & ~down_j
        if fc.straggler_success < 1.0:
            slow = ((bits_i | bits_j) & STRAGGLER) != 0
            ku = prng.fold_in(prng.fold_in(keys, _TAG_STRAGGLER), t0)
            u = prng.uniform(ku, (T, B)).transpose(0, 1)  # (T, R, B)
            succ = torch.tensor(fc.straggler_success, dtype=torch.float32,
                                device=dev)
            delivered = delivered & (~slow | (u < succ))
        upd_j = delivered & s.fwd_ok & ((bits_j & BYZ) == 0)
        upd_i = delivered & s.fwd_ok & s.rep_ok & ((bits_i & BYZ) == 0)
        # a wasted contact of a down partner still sends the forward leg
        cost_t = torch.where(attempt & ~down_j, s.cost,
                             adj.hops[s.pos.long()])
    offs = (torch.arange(R, device=dev, dtype=torch.int32) * nflat)[:, None]
    usage.index_add_(0, (s.pos + offs).reshape(-1),
                     attempt.to(torch.int32).reshape(-1))
    hops_t = torch.where(attempt, cost_t, 0)
    msgs += hops_t.sum(0, dtype=torch.int32)
    sample_retx, track_cong = cost_streams(cost)
    if sample_retx:
        # extra attempts of each single-hop transmission, Geometric(p):
        # one word a hop slot, masked to the hops actually sent
        kr = prng.fold_in(prng.fold_in(keys, _TAG_RETX), t0)
        u = torch.clamp_min(prng.uniform(kr, (T, B, 2 * hop_cap)), 1e-12)
        lq = torch.tensor(log_q(cost.retransmit_p), dtype=torch.float32,
                          device=dev)
        g = torch.floor(torch.log(u) / lq).to(torch.int32)  # (R, T, B, 2H)
        m = (torch.arange(2 * hop_cap, device=dev)
             < hops_t.transpose(0, 1)[..., None])
        retx += torch.where(m, g, 0).sum((1, 3), dtype=torch.int32)
    if track_cong:
        conc = attempt.sum(2, dtype=torch.int32)  # (T, R) exchanges a tick
        pairs = (attempt * torch.clamp_min(conc - 1, 0)[:, :, None]).sum(
            0, dtype=torch.int32)
        congp += pairs.to(torch.float32)
    return (s.i.reshape(T, R * B), s.j.reshape(T, R * B),
            upd_i.reshape(T, R * B), upd_j.reshape(T, R * B))
