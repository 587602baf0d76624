"""RG-LRU recurrent block (recurrentgemma / Griffin).

Block: x -> [linear -> short causal depthwise conv -> RG-LRU] gated by
a GeLU branch -> output projection.  The RG-LRU is a diagonal,
input-gated linear recurrence

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = exp(c * softplus(Lambda) * (-r_t))          in (0, 1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

For a full sequence (prefill and training) the recurrence runs in
chunks of `chunk` steps, each a log-depth doubling scan in f32 (the
reference runs `jax.lax.associative_scan` there), the state carried
between chunks and folded into each chunk's first element as the
reference folds it.  The sums come in another order than XLA's.  It is
plain tensor code and differentiable; the reference has no kernel here.
Decode is the O(1) state update.

The functions take `params` as any mapping of name to tensor: a dict,
or the `ParameterDict` of a `models.model.Transformer` block.  Given a
`models.sharded.Layout` (`lay`), they run on this rank's D/m channels
(the reference's specs, `src/repro/models/rglru.py:33-39`): the
column-parallel wx and wy, the conv, the gates and the scan on the
rank's channels, the conv's output gathered over "model" for the wa and
wi products, which take every channel, and the row-parallel wo; the
decode state holds the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import DTYPES, P_, dense

__all__ = ["rglru_params", "rglru_block", "rglru_decode", "init_rglru_state"]

_C = 8.0  # Griffin's scalar multiplier on the log-decay


def rglru_params(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    W = cfg.rglru_conv_width
    return {
        "wx": P_((D, D), spec=("data", "model")),  # recurrence branch in
        "wy": P_((D, D), spec=("data", "model")),  # gate branch in
        "conv": P_((W, D), init="normal", scale=0.1, spec=(None, "model")),
        "wa": P_((D, D), scale=0.5, spec=("data", "model")),
        "wi": P_((D, D), scale=0.5, spec=("data", "model")),
        "lam": P_((D,), init="normal", scale=0.5, spec=("model",)),
        "wo": P_((D, D), spec=("model", "data")),
    }


def _conv1d_causal(x, w, state=None):
    """Depthwise causal conv, width W. x: (B,S,D), w: (W,D).  With
    `state` ((B, W-1, D) trailing inputs) it is a streaming step."""
    W, S = w.shape[0], x.shape[1]
    if state is not None:
        x_ext = torch.cat([state, x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + x_ext[:, i:i + S] * w[i]
    return out.to(x.dtype)


def _gates(params, x, own=None):
    """The decay a and the input u of the recurrence, f32 (B, S, D), from
    the conv's output x; `own` is the channels of x whose gates these
    are (this rank's under a layout; all of x unless given)."""
    own = x if own is None else own
    a_log = (-_C * F.softplus(params["lam"].float())
             * torch.sigmoid(dense(x, params["wa"]).float()))
    a = torch.exp(a_log)
    i = torch.sigmoid(dense(x, params["wi"]).float())
    u = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * own.float())
    return a, u


def _scan(a, u):
    """h_t = a_t h_{t-1} + u_t along axis 1 from h_{-1} = 0, by doubling
    (Hillis-Steele): after the pass at distance d, each (a, u) holds the
    composition of the 2d steps ending at it."""
    d = 1
    while d < a.shape[1]:
        u = torch.cat([u[:, :d], u[:, d:] + a[:, d:] * u[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u


def _weights(params, cfg: ModelConfig, lay):
    """The weights as the block reads them: as they are, or under a
    layout this rank's blocks gathered over the dp dims."""
    return params if lay is None else lay.params(params, rglru_params(cfg))


def rglru_block(params, cfg: ModelConfig, x, chunk: int = 512, lay=None):
    """Full-sequence form (prefill and training). x: (B, S, D); under a
    layout `lay` (module docstring) x is replicated over "model", and the
    output is the hidden state's (`Layout.leave`)."""
    B, S, _ = x.shape
    w = _weights(params, cfg, lay)
    if lay is not None:
        x = lay.copy(x)
    gate = F.gelu(dense(x, w["wy"]), approximate="tanh")
    h_in = _conv1d_causal(dense(x, w["wx"]), w["conv"])
    h_all = h_in if lay is None else lay.gather(h_in)
    c = min(chunk, S)
    h0 = torch.zeros((B, h_in.shape[-1]), dtype=torch.float32,
                     device=x.device)
    hs = []
    for t in range(0, S, c):
        a, u = _gates(w, h_all[:, t:t + c], h_in[:, t:t + c])  # f32 (B, c, D)
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None], u[:, 1:]], dim=1)
        h = _scan(a, u)
        h0 = h[:, -1]
        hs.append(h.to(x.dtype))
    y = torch.cat(hs, dim=1) * gate
    out = dense(y, w["wo"])
    return out if lay is None else lay.leave(out)


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> dict:
    """The decode state on `device`: h (B, D) f32 and the conv's last
    W-1 inputs (B, W-1, D) in the model dtype."""
    return {
        "h": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, cfg.d_model),
                            dtype=DTYPES[cfg.dtype], device=device),
    }


def rglru_decode(params, cfg: ModelConfig, x, state: dict, lay=None):
    """One-token step. x: (B, 1, D); returns the output and a new state
    (under a layout, of this rank's channels)."""
    w = _weights(params, cfg, lay)
    gate = F.gelu(dense(x, w["wy"]), approximate="tanh")
    xr = dense(x, w["wx"])
    h_in = _conv1d_causal(xr, w["conv"], state=state["conv"])
    new_conv = torch.cat([state["conv"], xr], dim=1)[:, 1:]
    a, u = _gates(w, h_in if lay is None else lay.gather(h_in), h_in)
    h = a[:, 0] * state["h"] + u[:, 0]
    y = h[:, None].to(x.dtype) * gate
    out = dense(y, w["wo"])
    return (out if lay is None else lay.reduce(out)), {"h": h,
                                                        "conv": new_conv}
