"""Plain PyTorch version of the sample_chunk kernel: one gossip chunk's
exchange schedule and its accounting, as `gossip_core` computed them
around `core.schedule.sample_schedule`.

It draws the chunk with the bit-exact threefry of `core.prng` as eager
tensor ops (hundreds of launches a chunk on the card), folds the ``done``
freeze and the hop outcomes into the update bits, and counts usage with
one scatter-add and messages with one reduction.  It is the ``"ref"``
engine backend's draw and the yardstick the CUDA kernel is held against
bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.schedule import CsrGraphs, sample_schedule

__all__ = ["sample_chunk_ref"]


def sample_chunk_ref(t0: int, T: int, keys, adj: CsrGraphs,
                     loss_p: Optional[float], done, usage, msgs):
    """Draw ticks ``t0 .. t0+T-1`` for R trials of the same B graphs.

    Args:
      keys: (R, 2) int64 level keys, one a trial.
      adj: `CsrGraphs` of int32 tensors; ``nflat = adj.nbr.shape[0]``.
      loss_p: per-hop success probability, or None for no loss.
      done: (R, B) bool, graphs frozen for the whole chunk.
      usage: (R*nflat,) int32 flat per-edge exchange counters; the
        chunk's active exchanges are added in place.
      msgs: (R, B) int32 single-hop transmissions; the chunk's are added
        in place.
    Returns (i, j, upd_i, upd_j), each (T, R*B): int32 pairs and bool
    update bits, the value pass's input.
    """
    R, B = done.shape
    nflat = adj.nbr.shape[0]
    ts = torch.arange(t0, t0 + T, device=keys.device)
    s = sample_schedule(ts, keys, adj, loss_p)  # (T, R, B)
    active = s.valid & ~done                            # done frozen
    upd_j = active & s.fwd_ok
    upd_i = upd_j & s.rep_ok
    offs = (torch.arange(R, device=keys.device, dtype=torch.int32)
            * nflat)[:, None]
    usage.index_add_(0, (s.pos + offs).reshape(-1),
                     active.to(torch.int32).reshape(-1))
    msgs += torch.where(active, s.cost, 0).sum(0, dtype=torch.int32)
    return (s.i.reshape(T, R * B), s.j.reshape(T, R * B),
            upd_i.reshape(T, R * B), upd_j.reshape(T, R * B))
