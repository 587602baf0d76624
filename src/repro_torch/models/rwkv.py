"""RWKV-6 "Finch" block (rwkv6-3b): attention-free time mix with
data-dependent per-channel decay + squared-ReLU channel mix.

Time-mix (per head of width N):
    y_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t,   S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + tanh(x_w A) B)) — the defining Finch feature
(data-dependent decay, paper arXiv:2404.05892).  r/k/v/g use static
token-shift lerps; the decay path carries the low-rank data-dependent
delta.  The prefill's wkv recurrence runs through `kernels.rwkv6`
(the CUDA kernel on the card); decode runs the O(1) state update in
plain tensor ops.  Training (`train=True`) takes the reference's
`use_pallas=False` route: the plain recurrence `rwkv6_ref`, split into
time chunks of 256 each recomputed in backward, since the kernel is
forward only.

The functions take `p` as any mapping of name to tensor: a dict, or the
`ParameterDict` of a `models.model.Transformer` block.

Given a `models.sharded.Layout` (`lay`), they run sharded by the
reference's specs (`src/repro/models/rwkv.py:34-55`): the token shift
and the mixes on the whole (replicated) input, whose μ vectors every
"model" rank uses whole; wr, wk, wv, wg, the decay LoRA's wb and w0
column-parallel, the LoRA's wa whole; wo row-parallel.  Where "model"
divides the heads, the rank's columns are its H/m heads and the wkv
runs on them; where it does not, r, k, v and the decay are gathered
into whole heads, the wkv and the group norm run on the rank's share of
the B·H (row, head) units, and the outputs gathered back give the
rank's columns.  The channel mix reduce-scatters the row-parallel wv
product onto the rank's columns and multiplies it by the rank's
sigmoid(r): the rank's block of the hidden state where the layout
splits it, else gathered whole.  The time mix's row-parallel wo is
reduce-scattered there (`Layout.leave`).  Decode runs the wkv step on
every head on every rank, as the state (B·H, N, N) is split over the dp
dims only, and keeps the rank's columns of the token-shift buffers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.rwkv6 import rwkv6_ref, rwkv6_wkv
from .config import ModelConfig
from .layers import DTYPES, P_, dense

__all__ = [
    "rwkv_params", "rwkv_time_mix", "rwkv_channel_mix",
    "rwkv_time_mix_decode", "rwkv_channel_mix_decode", "init_rwkv_state",
]

_DECAY_LORA = 64
_TRAIN_BLOCK_T = 256  # the reference op's time chunk (block_t)


def rwkv_params(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        "time": {
            "mu_r": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "mu_k": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "mu_v": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "mu_g": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "mu_w": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "wr": P_((D, D), spec=("data", "model")),
            "wk": P_((D, D), spec=("data", "model")),
            "wv": P_((D, D), spec=("data", "model")),
            "wg": P_((D, D), spec=("data", "model")),
            "w0": P_((D,), init="normal", scale=0.5, spec=("model",)),
            "wa": P_((D, _DECAY_LORA), scale=0.5, spec=("data", None)),
            "wb": P_((_DECAY_LORA, D), scale=0.5, spec=(None, "model")),
            "u": P_((H, N), init="normal", scale=0.2, spec=("model", None)),
            "ln_scale": P_((D,), init="ones", dtype="float32",
                           spec=("model",)),
            "wo": P_((D, D), spec=("model", "data")),
        },
        "channel": {
            "mu_k": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "mu_r": P_((D,), init="normal", scale=0.2, spec=("model",)),
            "wk": P_((D, F_), spec=("data", "model")),
            "wv": P_((F_, D), spec=("model", "data")),
            "wr": P_((D, D), spec=("data", "model")),
        },
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros / `prev` at t=0). x: (B,S,D)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _decay(p, xw):
    """exp(-exp(w0 + tanh(xw wa) wb)) in f32: xw is f32 while wa and wb
    are in the model dtype, so both products run in f32."""
    lora = torch.tanh(xw @ p["wa"].float()) @ p["wb"].float()
    return torch.exp(-torch.exp(p["w0"].float() + lora))


def _group_norm(y, scale, H, N, eps=1e-5):
    """Per-head layernorm of the wkv output (B,S,H,N)."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    return (yn.reshape(*y.shape[:2], H * N) * scale).to(y.dtype)


def wkv_train(r, k, v, w, u, block_t: int = _TRAIN_BLOCK_T):
    """The differentiable wkv of training: `rwkv6_ref` over time chunks
    of `block_t`, each recomputed in backward, the state carried between
    them (so only a chunk's per-step states are ever saved).  As the
    reference's `use_pallas=False` op, one unchunked pass when T <=
    block_t or T is no multiple of it."""
    BH, T, N = r.shape
    bt = min(block_t, T)
    if T <= bt or T % bt:
        return rwkv6_ref(r, k, v, w, u)

    def chunk(rc, kc, vc, wc, s):
        return rwkv6_ref(rc, kc, vc, wc, u, s0=s, return_state=True)

    s = torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(0, T, bt):
        y, s = checkpoint(chunk, *(a[:, t:t + bt] for a in (r, k, v, w)), s,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _weights(p, cfg: ModelConfig, part: str, lay, whole=()):
    """The weights of `part` ("time" or "channel") as the block reads
    them: as they are, or under a layout the μ vectors and wa whole
    (`Layout.shared`), the names in `whole` too, every other weight this
    rank's block gathered over the dp dims."""
    if lay is None:
        return p
    descr = rwkv_params(cfg)[part]
    shared = {n for n in descr if n.startswith("mu_")} | {"wa", *whole}
    return {n: (lay.shared if n in shared else lay.param)(p[n], d)
            for n, d in descr.items()}


def _to_bh(a, H: int, N: int):
    """(B, S, H·N) -> (B·H, S, N), contiguous."""
    B, S = a.shape[:2]
    return a.reshape(B, S, H, N).transpose(1, 2).reshape(B * H, S, N)


def rwkv_time_mix(p, cfg: ModelConfig, x, *, train: bool = False,
                  lay=None):
    """x: (B, S, D); under a layout (module docstring) replicated over
    "model", the output the hidden state's (`Layout.leave`)."""
    B, S, D = x.shape
    H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
    by_heads = lay is None or H % lay.m == 0
    p = _weights(p, cfg, "time", lay,
                 whole=() if by_heads else ("u", "ln_scale"))
    if lay is not None:
        x = lay.copy(x)
    sx = _shift(x) - x
    xr = x + sx * p["mu_r"]
    xk = x + sx * p["mu_k"]
    xv = x + sx * p["mu_v"]
    xg = x + sx * p["mu_g"]
    xw = (x + sx * p["mu_w"]).float()
    r = dense(xr, p["wr"])
    k = dense(xk, p["wk"])
    v = dense(xv, p["wv"])
    g = F.silu(dense(xg, p["wg"]))
    w = _decay(p, xw)                                       # (B,S,D) in (0,1)
    # the decay stays f32: bf16-rounding w compounds through the state;
    # u is rounded to the working type, as the reference passes it
    wkv = wkv_train if train else rwkv6_wkv
    if by_heads:                    # this rank's columns are whole heads
        Hl = p["u"].shape[0]
        u = p["u"][None].expand(B, Hl, N).reshape(B * Hl, N)
        y = wkv(_to_bh(r, Hl, N), _to_bh(k, Hl, N), _to_bh(v, Hl, N),
                _to_bh(w, Hl, N), u.to(r.dtype).contiguous())  # (B*Hl, S, N)
        y = y.reshape(B, Hl, S, N).transpose(1, 2)           # (B,S,Hl,N)
        y = _group_norm(y, p["ln_scale"], Hl, N)
    else:
        y = _wkv_units(p, lay, wkv, *(lay.gather(a) for a in (r, k, v, w)),
                       H, N)
    out = dense(y * g, p["wo"])
    return out if lay is None else lay.leave(out)


def _wkv_units(p, lay, wkv, r, k, v, w, H: int, N: int):
    """The wkv and the group norm on this rank's share of the B·H (row,
    head) units of whole r, k, v, w (B, S, D), u and ln_scale whole;
    the normalised outputs gathered back, this rank's columns (B, S,
    D/m) returned."""
    B, S, D = r.shape
    start, stop, counts = lay.units(B * H)
    head = torch.arange(start, stop, device=r.device) % H
    u = p["u"][head].to(r.dtype).contiguous()
    y = wkv(*(_to_bh(a, H, N)[start:stop] for a in (r, k, v, w)), u)
    # each unit's head alone, with its head's scale
    y = _group_norm(y[:, :, None], p["ln_scale"].reshape(H, N)[head][:, None],
                    1, N)
    y = lay.gather(y, 0, counts)                            # (B*H, S, N)
    return lay.block(y.reshape(B, H, S, N).transpose(1, 2).reshape(B, S, D))


def rwkv_channel_mix(p, cfg: ModelConfig, x, *, lay=None, prev=None):
    """x: (B, S, D); `prev` (B, 1, D) the token before x (zeros unless
    given).  Under a layout (module docstring) x and `prev` are
    replicated over "model"; the output is the rank's channels where the
    layout splits the hidden state (`Layout.hidden_split`), else
    gathered whole."""
    p = _weights(p, cfg, "channel", lay)
    if lay is not None:
        x = lay.copy(x)
    sx = _shift(x, prev) - x
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(torch.relu(dense(xk, p["wk"])))
    if lay is None:
        return torch.sigmoid(dense(xr, p["wr"])) * dense(k, p["wv"])
    kv = lay.reduce_scatter(dense(k, p["wv"]))              # (B,S,D/m)
    y = torch.sigmoid(dense(xr, p["wr"])) * kv
    return y if lay.hidden_split else lay.gather(y, summed=False)


# ------------------------------ decode --------------------------------


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = DTYPES[cfg.dtype]
    return {
        "tm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dt, device=device),
        "cm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dt, device=device),
        "wkv": torch.zeros((batch * H, N, N), dtype=torch.float32, device=device),
    }


def rwkv_time_mix_decode(p, cfg: ModelConfig, x, state: dict, lay=None):
    """x: (B, 1, D); O(1) state update.  Under a layout (module
    docstring) every head on every rank: the rank's column blocks of r,
    k, v, g and the decay gathered whole."""
    B, _, D = x.shape
    H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
    p = _weights(p, cfg, "time", lay, whole=("u", "ln_scale"))
    whole = (lambda a: a) if lay is None else lay.gather  # noqa: E731
    prev = whole(state["tm_prev"])
    sx = prev - x
    xr, xk, xv, xg = (x + sx * p[m] for m in ("mu_r", "mu_k", "mu_v", "mu_g"))
    xw = (x + sx * p["mu_w"]).float()
    r = whole(dense(xr, p["wr"])).reshape(B * H, N)
    k = whole(dense(xk, p["wk"])).reshape(B * H, N).float()
    v = whole(dense(xv, p["wv"])).reshape(B * H, N).float()
    g = F.silu(whole(dense(xg, p["wg"])))
    w = whole(_decay(p, xw)).reshape(B * H, N)
    u = p["u"][None].expand(B, H, N).reshape(B * H, N).float()
    s = state["wkv"]                                        # (BH, N, N)
    kv = k[:, :, None] * v[:, None, :]
    y = torch.einsum("bnm,bn->bm", s + u[:, :, None] * kv, r.float())
    s_new = w[:, :, None] * s + kv
    y = y.reshape(B, 1, H, N).to(x.dtype)
    y = _group_norm(y, p["ln_scale"], H, N)
    yg = (y * g).to(x.dtype)
    if lay is None:
        return dense(yg, p["wo"]), {**state, "tm_prev": x, "wkv": s_new}
    out = lay.reduce(dense(lay.block(yg), p["wo"]))
    return out, {**state, "tm_prev": lay.block(x), "wkv": s_new}


def rwkv_channel_mix_decode(p, cfg: ModelConfig, x, state: dict, lay=None):
    """x: (B, 1, D); under a layout `state` holds this rank's columns of
    the previous token, and so does the new state."""
    if lay is None:
        out = rwkv_channel_mix(p, cfg, x, prev=state["cm_prev"])
        return out, {**state, "cm_prev": x}
    out = rwkv_channel_mix(p, cfg, x, lay=lay,
                           prev=lay.gather(state["cm_prev"]))
    return out, {**state, "cm_prev": lay.block(x)}
