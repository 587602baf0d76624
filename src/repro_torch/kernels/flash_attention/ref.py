"""Plain PyTorch version of flash attention: the full softmax in f32,
masks by index with the -1e30 sentinel, GQA by repeating the KV heads."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..._tf32 import no_tf32

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.  Query i
    sees key j when ``j <= i`` (causal) and ``j > i - window`` (window).
    Returns (B, Hq, Sq, Dv) in q's dtype."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    with no_tf32():
        s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_idx = torch.arange(Sq, device=q.device)[:, None]
        k_idx = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_idx <= q_idx
        if window is not None:
            mask &= k_idx > q_idx - window
        s = torch.where(mask, s, -1e30)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
