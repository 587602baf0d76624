"""Bit-exact threefry-2x32: the counter-based generator behind the
exchange schedule.

The exchange schedule is this system's output — message counts, per-node
sends and per-level ticks are all functions of the random draws — so the
port reproduces the reference generator (jax's threefry) bit for bit
instead of swapping in another one.  Only the pieces the simulation uses
are here:

* `PRNGKey(seed)` — the raw key ``(0, seed mod 2**32)`` (32-bit seeds);
* `fold_in(key, data)` — ``threefry2x32(key, (0, data))``;
* `split(key, num)` — `num` subkeys;
* `random_bits(key, shape)` — 32-bit words;
* `uniform(key, shape)` — f32 in ``[0, 1)`` from the top 23 bits;
* `permutation(key, n)` — a shuffle of ``0 .. n-1`` (the decentralized
  sync's replica fault sets).

jax lays out the counters of `split` and `random_bits` in one of two
ways, chosen by its ``jax_threefry_partitionable`` flag.  The port has
one layout, the flag's ``False`` (jax 0.4's default): the counters
``0 .. N-1`` are cut into halves that feed the two words, ``bits =
concat(y1, y2)[:N]``, and `split` takes ``N = 2 * num`` bits as key
pairs.  The repository's recorded large-n message counts were drawn this
way; under jax 0.9's default (``True``) the reference draws other
numbers, so parity with it holds inside
``jax.threefry_partitionable(False)``.

Words are held in int64 tensors masked to 32 bits: torch's uint32 lacks
most ops on CUDA and ``>>`` on int32 is arithmetic, while int64 add,
xor, shift and mask are exact and identical on every device.  Keys are
int64 tensors of shape ``(..., 2)``; every function takes a leading
batch of keys (trials, ticks) and broadcasts it in front of the drawn
shape.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "threefry2x32",
    "PRNGKey",
    "fold_in",
    "split",
    "random_bits",
    "uniform",
    "permutation",
]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 hash of the counter pair (x1, x2) under
    key (k1, k2); all four broadcast together.  Returns (y1, y2)."""
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


def _key_words(key):
    """(k1, k2) of a (*K, 2) key batch, shaped (*K, 1) to broadcast
    against a trailing counter axis."""
    return key[..., 0, None], key[..., 1, None]


def _halves_bits(key, size: int):
    """Counters 0..size-1 (zero-padded to even) split into halves for the
    two words; returns (*K, size)."""
    half = (size + 1) // 2
    x1 = torch.arange(half, dtype=torch.int64, device=key.device)
    x2 = x1 + half
    if size % 2:
        x2[-1] = 0
    y1, y2 = threefry2x32(*_key_words(key), x1, x2)
    return torch.cat([y1, y2], dim=-1)[..., :size]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key of an integer seed: ``(0, seed mod 2**32)``, as the
    reference builds it without 64-bit mode."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold integer `data` (an int or a tensor broadcasting against the
    key batch) into `key`: ``threefry2x32(key, (0, data))``."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    d = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(..., num, 2)`` subkeys of a ``(..., 2)`` key batch."""
    return _halves_bits(key, 2 * num).reshape(*key.shape[:-1], num, 2)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``(..., *shape)`` 32-bit random words (int64 in ``[0, 2**32)``)."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if size >= _MASK:
        raise NotImplementedError("draws of 2**32 - 1 words or more")
    return _halves_bits(key, size).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``(..., *shape)`` float32 uniform draws in ``[0, 1)``: the top 23
    bits become the mantissa of a float in ``[1, 2)``, minus one."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """A shuffle of ``0 .. n-1`` (int64) under one ``(2,)`` key, as
    ``jax.random.permutation(key, n)`` draws it: ``ceil(3 ln n /
    ln(2**32 - 1))`` rounds (one for 2 <= n <= 1625, none for n = 1), each
    splitting the key, drawing n 32-bit sort keys from the subkey and
    sorting the values by them, stably (ties keep their order)."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
