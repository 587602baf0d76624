"""Gradient compression with error feedback for gossip synchronization.

Gossip strategies trade exactness for message cost; compression trades
wire bytes for a bounded, *recoverable* error: whatever a round does not
send is kept in a per-replica residual and re-injected next round
(error feedback, Seide et al. / Karimireddy et al.), so compressed
averaging still moves all gradient mass eventually.

Schemes
-------
``none``   identity (returns its inputs untouched).
``topk``   per replica, keep the k = max(1, frac * D) largest-magnitude
           entries of the (gradient + residual) accumulator, and every
           entry tied with the k-th: the sent tensor plus the new
           residual reconstructs the accumulator bitwise.
``int8``   symmetric per-replica quantization to 127 bins: |error| <=
           max|g| / 127 per entry; wire cost 1 byte vs 4 (fraction
           0.25).

A scheme's decision needs one statistic of each replica's whole row
(`row_stats`: the k-th largest magnitude, or the largest); given it,
each entry is sent or kept on its own (`sent`), so the executor runs a
large leaf in pieces of columns.  `compress` is the whole-tree form.
Leaves are tensors with a leading replica axis R.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "CompressionConfig",
    "compress",
    "decompress",
    "init_residual",
    "row_stats",
    "sent",
    "wire_fraction",
]

SCHEMES = ("none", "topk", "int8")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"
    topk_fraction: float = 0.25

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"unknown scheme {self.scheme!r}; expected one of {SCHEMES}"
            )
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction}"
            )


def init_residual(grads: dict) -> dict:
    """Zero error-feedback residual matching the gradient dict."""
    return {k: torch.zeros_like(g) for k, g in grads.items()}


def row_stats(grads: torch.Tensor, residual: torch.Tensor,
              cfg: CompressionConfig) -> torch.Tensor:
    """The (R,) statistic of each replica's accumulator row
    ``grads[r] + residual[r]`` that `sent` needs, in the leaf's dtype:
    topk the k-th largest magnitude, int8 the quantization step
    max|acc_r| / 127.  One row's accumulator lives at a time."""
    R = grads.shape[0]
    d = grads[0].numel()
    k = max(1, int(cfg.topk_fraction * d))
    out = []
    for r in range(R):
        mag = (grads[r] + residual[r]).abs().reshape(-1)
        if cfg.scheme == "topk":
            # the smallest of the k largest: the k-th largest, ties counted
            out.append(torch.topk(mag, k, sorted=False).values.min())
        else:
            out.append(mag.max() / 127.0)
        del mag
    return torch.stack(out)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def sent(acc: torch.Tensor, stats: torch.Tensor,
         cfg: CompressionConfig) -> torch.Tensor:
    """The as-transmitted payload of accumulator entries `acc` (R, ...)
    (any piece of the rows `stats` was taken over)."""
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    if cfg.scheme == "topk":
        return torch.where(acc.abs() >= _rows(stats, acc), acc, zero)
    # int8: q = round(x / s), s = max|x_r| / 127 per replica row
    scale = _rows(stats, acc)
    safe = torch.clamp_min(scale, torch.finfo(acc.dtype).tiny)
    q = torch.clamp(torch.round(acc / safe), -127, 127).to(torch.int8)
    return torch.where(scale > 0, q.to(acc.dtype) * safe, zero)


def compress(grads: dict, residual: dict,
             cfg: CompressionConfig) -> tuple[dict, dict]:
    """(payload, new_residual) with payload + new_residual == grads +
    residual reconstructing the accumulator BITWISE for both schemes:
    topk entries are exact copies or exact leftovers, and int8's
    per-entry subtraction acc - dequant is Sterbenz-exact (entries that
    quantize to zero leave the accumulator itself as residual), so no
    gradient mass is created or destroyed by a sync, only deferred.
    Decisions are made per replica (each transmits independently)."""
    if cfg.scheme == "none":
        return grads, residual
    payload, new_res = {}, {}
    for k, g in grads.items():
        acc = g + residual[k]
        payload[k] = sent(acc, row_stats(g, residual[k], cfg), cfg)
        new_res[k] = acc - payload[k]
    return payload, new_res


def decompress(payload: dict, cfg: CompressionConfig) -> dict:
    """Wire-decoding hook; dense simulated payloads decode to themselves."""
    del cfg
    return payload


def wire_fraction(cfg: CompressionConfig) -> float:
    """Bytes on the wire relative to dense float32.

    topk ships (value, index) pairs — 2x per kept entry, capped at dense
    cost (a sender would fall back to dense past the break-even point);
    int8 ships one byte per entry plus a scalar scale (amortized away).
    """
    if cfg.scheme == "none":
        return 1.0
    if cfg.scheme == "int8":
        return 0.25
    return min(1.0, 2.0 * cfg.topk_fraction)
