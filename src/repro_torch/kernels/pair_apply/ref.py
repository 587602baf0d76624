"""Plain PyTorch version of the pair-apply kernel: the sequential
pair-average recursion over a presampled exchange schedule.

Line for line the reference's oracle: gather rows i and j, average them
as ``0.5 * (xi + xj)``, then write row j and after it row i, each only
where its update bit is set.  It is the ``"ref"`` engine backend and the
yardstick the CUDA kernel is held against bitwise.
"""
from __future__ import annotations

import torch

__all__ = ["pair_apply_ref"]


def pair_apply_ref(x, i, j, upd_i, upd_j):
    """Apply a presampled pair list to batched cell state.

    Args:
      x: (B, C, V) float32 node values.
      i, j: (T, B) int exchange pairs (j already clipped to >= 0).
      upd_i, upd_j: (T, B) bool — whether the initiator / partner row
        updates at that tick (validity, done freeze and per-hop loss
        outcomes already folded in).
    Returns the (B, C, V) state after the T ticks, in order.
    """
    B, C, V = x.shape
    bidx = torch.arange(B, device=x.device)
    slots = torch.arange(C, device=x.device)[None, :]
    i, j = i.long(), j.long()
    upd_i, upd_j = upd_i.bool(), upd_j.bool()
    for t in range(i.shape[0]):
        it, jt = i[t], j[t]
        xi = x[bidx, it]
        xj = x[bidx, jt]
        avg = 0.5 * (xi + xj)
        # row writes as one-hot masked selects: partner row first, then
        # initiator (the reference's order)
        oh_j = (slots == jt[:, None]) & upd_j[t][:, None]
        oh_i = (slots == it[:, None]) & upd_i[t][:, None]
        x = torch.where(oh_j[..., None], avg[:, None, :], x)
        x = torch.where(oh_i[..., None], avg[:, None, :], x)
    return x
