"""Plain PyTorch version of the RWKV-6 wkv recurrence: a loop over time
in f32, the output cast to ``r.dtype``."""
from __future__ import annotations

import torch

__all__ = ["rwkv6_ref"]


def rwkv6_ref(r, k, v, w, u, s0=None, return_state: bool = False):
    """r/k/v/w: (BH, T, N); u: (BH, N). Returns (BH, T, N) [, final state].

    Per b·h, from the (N, N) f32 state S (keys x values, `s0` or zeros):
    ``y_t = (S + (u * k_t) v_t^T)^T r_t``, then ``S <- diag(w_t) S + k_t v_t^T``.
    """
    BH, T, N = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[:, :, None]
    s = (torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]          # (BH, N, N)
        ys.append(((s + uf * kv) * rf[:, t, :, None]).sum(1))
        s = wf[:, t, :, None] * s + kv
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((BH, 0, N), dtype=torch.float32, device=r.device))
    out = y.to(r.dtype)
    if return_state:
        return out, s
    return out
