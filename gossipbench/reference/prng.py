"""Threefry-2x32 as jax draws it with ``jax_threefry_partitionable``
off: the generator behind every exchange decision of the simulation.

A frozen copy of the bit-exact generator the benchmark's reference
needs: `PRNGKey`, `fold_in`, `split` and `uniform`.  Words are int64
tensors masked to 32 bits, so the arithmetic is exact on any device.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The 20-round hash of counters (x1, x2) under key (k1, k2)."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for block in range(5):
        for r in _ROT[block % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & _MASK
        x2 = (x2 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``threefry2x32(key, (0, data))`` for a (..., 2) key batch."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    d = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def _bits(key: torch.Tensor, size: int) -> torch.Tensor:
    """(*K, size) words: counters 0..size-1, zero-padded to even, cut in
    halves that feed the two words."""
    half = (size + 1) // 2
    x1 = torch.arange(half, dtype=torch.int64, device=key.device)
    x2 = x1 + half
    if size % 2:
        x2[-1] = 0
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], x1, x2)
    return torch.cat([y1, y2], dim=-1)[..., :size]


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """(..., num, 2) subkeys."""
    return _bits(key, 2 * num).reshape(*key.shape[:-1], num, 2)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """(..., *shape) float32 in [0, 1) from the top 23 bits of a word."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    bits = _bits(key, size).reshape(*key.shape[:-1], *shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)
