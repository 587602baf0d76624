"""Mixture-of-experts FFN (llama4-maverick top-1 x 128e, grok-1 top-2 x 8e).

Sort-based dispatch with a static per-expert capacity, as the
reference computes it without its sharding constraints: f32 router
logits, softmax, top-K and the K gates renormalised; the token-to-expert
assignments sorted stably by expert, each token ranked within its
expert, and tokens beyond the capacity dropped (their residual passes
through).  The tokens go to the experts through an (E, C) index map and
come back through the inverse permutation of the sort.  Expert weights
are (E, din, dout); the expert products emit the model dtype, as in the
reference, and are plain batched products, which the reference computes
outside any kernel too.

The functions take `params` as any mapping of name to tensor: a dict,
or the `ParameterDict` of a `models.model.Transformer` block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import P_

__all__ = ["moe_params", "moe_ffn"]


def moe_params(cfg: ModelConfig, model_axis: int = 16) -> dict:
    """The router and the expert weights.  Their specs put the experts
    over "model" when `model_axis` divides E (expert parallel), else
    the expert's hidden dim (tensor parallel inside each expert), as
    the reference chooses; the sharded MoE is not ported yet (a model
    mesh raises in `models.sharded`)."""
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    if E % model_axis == 0:
        spec_in, spec_out = ("model", "data", None), ("model", None, "data")
    else:
        spec_in, spec_out = (None, "data", "model"), (None, "model", "data")
    return {
        "router": P_((D, E), scale=0.1, spec=("data", None)),
        "wi": P_((E, D, F_), spec=spec_in),
        "wg": P_((E, D, F_), spec=spec_in),
        "wo": P_((E, F_, D), spec=spec_out),
    }


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert holds for a chunk of `tokens` tokens:
    capacity_factor * T * K / E, at least 1, rounded up to a multiple
    of 256."""
    C = max(1, int(cfg.moe_capacity_factor * tokens * cfg.experts_per_token
                   / cfg.num_experts))
    return C + (-C) % 256


def moe_ffn(params, cfg: ModelConfig, x, token_chunk: int = 131_072):
    """x: (B, S, D) -> (B, S, D).  The B*S tokens are routed in chunks
    of `token_chunk`, each with its own capacity; in one chunk when the
    count is no multiple of it."""
    B, S, D = x.shape
    T = B * S
    tc = min(token_chunk, T)
    if T % tc:
        tc = T
    xt = x.reshape(T, D)
    out = [_moe_chunk(params, cfg, xt[t:t + tc]) for t in range(0, T, tc)]
    return torch.cat(out).reshape(B, S, D)


def _top_k(gate_all, K: int):
    """The K largest gates of each row and their experts, the lower
    expert first among equal gates, as `lax.top_k` orders them."""
    gates, experts = torch.sort(gate_all, dim=-1, descending=True,
                                stable=True)
    return gates[:, :K], experts[:, :K]


def _moe_chunk(params, cfg: ModelConfig, xt):
    """Route, dispatch, the expert FFN and combine for (T, D) tokens."""
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    # f32 router logits: bf16 products are exact in f32, so this is the
    # reference's f32-accumulated product
    logits = xt.float() @ params["router"].to(xt.dtype).float()
    gates, experts = _top_k(torch.softmax(logits, dim=-1), K)   # (T, K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # the assignments sorted by expert, each ranked within its expert
    flat_e = experts.reshape(-1)                                # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T * K, device=xt.device) - first
    C = capacity(cfg, T)
    keep = rank < C
    slot_c = torch.where(keep, rank, C)             # overflow -> column C

    # dispatch: an (E, C + 1) index map of source tokens (T: the zero
    # row), column C the sink of dropped assignments, then one gather
    idx = torch.full((E, C + 1), T, dtype=torch.long, device=xt.device)
    idx[sorted_e, slot_c] = order // K
    xt_pad = torch.cat([xt, xt.new_zeros((1, D))])
    h = xt_pad[idx[:, :C]]                                      # (E, C, D)

    up = torch.bmm(h, params["wi"])
    gset = torch.bmm(h, params["wg"])
    out_e = torch.bmm(F.silu(gset) * up, params["wo"])          # (E, C, D)

    # combine: a gather back through the inverse permutation; a dropped
    # assignment reads the zero row C with weight 0
    out_pad = torch.cat([out_e, out_e.new_zeros((E, 1, D))], dim=1)
    inv = torch.argsort(order)
    c_of = slot_c[inv].reshape(T, K)
    keep_tk = keep[inv].reshape(T, K)
    gathered = out_pad[experts, c_of]                           # (T, K, D)
    w = (gates * keep_tk).to(xt.dtype)
    return torch.einsum("tkd,tk->td", gathered, w).to(xt.dtype)
