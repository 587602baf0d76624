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

Under a mesh (`launch.mesh.set_mesh`) and with `dp=`, `moe_ffn` runs
sharded (`models.sharded`) on this rank's rows and computes the
unsharded function on them, drops included:

* capacity and ranks stay global.  The chunks are cut from the global
  token order, and an assignment's rank within its expert counts every
  earlier assignment of its chunk, on the data-parallel ranks before
  this one too: its local stable rank plus an exclusive prefix of the
  ranks' per-expert counts, all-gathered over the dp dims (in
  `data.shard_batch`'s row order).  Where the chunks tile each rank's
  rows, the prefix is zero and nothing is gathered;
* the experts follow their specs (`moe_params` at `model_axis` 16):
  where "model" splits E (expert parallel) each rank computes its E/m
  experts on its kept tokens; where it splits d_ff (tensor parallel
  inside each expert) every expert's wi / wg columns and wo rows.  Both
  give a partial (T, D) combine that `Layout.leave` completes into the
  hidden state's layout (the rank's block of D where it is split).  The
  router is used whole on the norm's whole output, but the gates
  weigh only the rank's partial outputs, so its gradient and the
  input's are summed over "model" (`Layout.shared`, `copy_to_model`);
* each rank's expert buffer holds the kept tokens of its rows only,
  padded to the largest such count of any expert on any rank (a pmax),
  never the global (E, C) buffer.  On fake tensors (a dry run's trace,
  `launch.dryrun`) no count is known, so the buffer takes the capacity
  of the rank's chunks, the rows the reference's program allocates, and
  the masked gathers run unmasked at the same shapes; the pmax is still
  called, so the collectives are the real run's;
* the FSDP ("data") split of the experts' width is gathered either as
  the weights, an expert at a time, or where that moves fewer bytes as
  the tokens: the buffers of the ranks along "data" are gathered, each
  rank multiplies them by its width block of the weights and the
  partial products are reduce-scattered back to each rank's rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import collectives as C
from ..kernels._fake import FakeTensor
from . import sharded
from .config import ModelConfig
from .layers import P_

__all__ = ["moe_params", "moe_ffn"]


def moe_params(cfg: ModelConfig, model_axis: int = 16) -> dict:
    """The router and the expert weights.  Their specs put the experts
    over "model" when `model_axis` divides E (expert parallel), else
    the expert's hidden dim (tensor parallel inside each expert), as
    the reference chooses."""
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


def moe_ffn(params, cfg: ModelConfig, x, token_chunk: int = 131_072, *,
            dp=None):
    """x: (B, S, D) -> (B, S, D).  The B*S tokens are routed in chunks
    of `token_chunk`, each with its own capacity; in one chunk when the
    count is no multiple of it.

    `dp` (the data-parallel dims, or a `sharded.Layout`) under a mesh:
    sharded on this rank's rows (module docstring); x replicated over
    "model", the output the hidden state's (`Layout.leave`)."""
    lay = sharded.layout(None, dp)
    if lay is not None:
        return _moe_sharded(params, cfg, x, token_chunk, lay)
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


def _route(router, cfg: ModelConfig, xt):
    """(gates, experts) (T, K) of the tokens xt: f32 logits, softmax,
    top-K and the K gates renormalised."""
    # f32 router logits: bf16 products are exact in f32, so this is the
    # reference's f32-accumulated product
    logits = xt.float() @ router.to(xt.dtype).float()
    gates, experts = _top_k(torch.softmax(logits, dim=-1),
                            cfg.experts_per_token)
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), experts


def _moe_chunk(params, cfg: ModelConfig, xt):
    """Route, dispatch, the expert FFN and combine for (T, D) tokens."""
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    gates, experts = _route(params["router"], cfg, xt)          # (T, K)

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


# ------------------------------ sharded -------------------------------


def _moe_sharded(params, cfg: ModelConfig, x, token_chunk: int, lay):
    """`moe_ffn` on this rank's rows x (B/dp, S, D) under layout `lay`
    (module docstring)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    descr = moe_params(cfg)
    split = lay.split(descr["wi"])
    ep = split and lay.spec(descr["wi"])[0] is not None
    El = E // lay.m if ep else E
    e0 = lay.model_index() * El if ep else 0
    n_dp, r = C.axis_size(lay.mesh, lay.dp), C.axis_index(lay.mesh, lay.dp)
    Tg = T * n_dp
    tc = min(token_chunk, Tg)
    if Tg % tc:
        tc = Tg
    cap = capacity(cfg, tc)
    z = lay.copy(x) if split else x
    zt = z.reshape(T, D)
    router = (lay.shared if split else lay.param)(params["router"],
                                                 descr["router"])
    dev = x.device
    o = r * T                       # this rank's first token, globally
    parts = [(c, max(o, c * tc) - o, min(o + T, (c + 1) * tc) - o)
             for c in range(o // tc, (o + T - 1) // tc + 1)]
    routed = [_route(router, cfg, zt[a:b]) for _, a, b in parts]
    prefix = torch.zeros((Tg // tc, E), dtype=torch.long, device=dev)
    # a fake x is a dry run's trace (`launch.dryrun`): no size may
    # depend on the data, so the buffer takes the capacity's rows
    fake = isinstance(x, FakeTensor)
    if T % tc:
        # the chunks span ranks: each assignment's rank counts those of
        # the ranks before this one in its chunk
        counts = torch.zeros_like(prefix)
        for (c, _, _), (_, experts) in zip(parts, routed):
            counts[c] = _bincount(experts.reshape(-1), E)
        every = C.all_gather(counts[None], lay.mesh, lay.dp)
        prefix = every[:r].sum(0)

    # each part's assignments, sorted by expert and ranked within it;
    # the rank's kept ones of its own experts take consecutive slots of
    # their expert's rows, part after part
    filled = torch.zeros((El,), dtype=torch.long, device=dev)
    cols = {"gate": [], "e": [], "slot": [], "keep": [], "mine": []}
    src, e_mine, s_mine = [], [], []
    for (c, a, _), (gates, experts) in zip(parts, routed):
        Tp = gates.shape[0]
        flat_e = experts.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        rank = torch.arange(Tp * K, device=dev) - first
        keep = rank + prefix[c][sorted_e] < cap
        mine = keep & (sorted_e >= e0) & (sorted_e < e0 + El)
        e_loc = torch.where(mine, sorted_e - e0, 0)
        slot = filled[e_loc] + rank
        filled = filled + _bincount(e_loc, El, mine)
        # a trace takes the same shapes' work, every assignment kept
        sel = slice(None) if fake else mine
        src.append((a + order // K)[sel])
        e_mine.append(e_loc[sel])
        s_mine.append(slot[sel])
        inv = torch.argsort(order)
        for key, v in (("gate", gates), ("e", e_loc[inv]),
                       ("slot", slot[inv]), ("keep", keep[inv]),
                       ("mine", mine[inv])):
            cols[key].append(v.reshape(Tp, K))
    cols = {k: torch.cat(v) for k, v in cols.items()}

    # one row count for every rank, so every rank builds the same graph;
    # a trace bounds it by the capacity of the rank's chunks, the rows
    # the reference's program allocates
    n = C.pmax(filled.max()[None], lay.mesh,
               lay.dp + (("model",) if "model" in lay.sizes else ()))
    n = cap * len(parts) if fake else int(n)
    idx = torch.full((El, n + 1), T, dtype=torch.long, device=dev)
    idx[torch.cat(e_mine), torch.cat(s_mine)] = torch.cat(src)
    h = torch.cat([zt, zt.new_zeros((1, D))])[idx[:, :n]]       # (El, n, D)
    out_e = _experts(params, descr, h, lay)

    # combine: a dropped assignment, or one of another rank's experts,
    # reads the zero row n
    out_pad = torch.cat([out_e, out_e.new_zeros((El, 1, D))], dim=1)
    slot = torch.where(cols["mine"], cols["slot"], n)
    gathered = out_pad[cols["e"], slot]                         # (T, K, D)
    w = (cols["gate"] * cols["keep"]).to(x.dtype)
    y = torch.einsum("tkd,tk->td", gathered, w).to(x.dtype)
    y = lay.leave(y) if split else lay.part(y)
    return y.reshape(B, S, y.shape[-1])


def _bincount(v, n: int, where=None):
    """`torch.bincount(v[where], minlength=n)` of values below n, at
    shapes that do not depend on the data (a fake v's trace runs it)."""
    ones = torch.ones_like(v) if where is None else where.to(v.dtype)
    return v.new_zeros((n,)).scatter_add_(0, v, ones)


def _experts(params, descr: dict, h, lay):
    """The expert FFN of the rank's buffer h (El, n, D): its experts'
    products, partial over "model" where it splits d_ff.  The FSDP split
    of the width is gathered as the weights or as the tokens (module
    docstring)."""
    fsdp = tuple(a for a in lay.fsdp_dims(descr["wi"], 1)
                 if lay.sizes[a] > 1)
    nd = C.axis_size(lay.mesh, fsdp)
    El, n, D = h.shape
    Fl = params["wi"].shape[2]          # d_ff, or its block over "model"
    size = h.element_size()
    # bytes a rank moves an expert: the three weights gathered, or the
    # buffers gathered and the two f32 partial products summed
    if not fsdp or 3 * D * Fl * size <= nd * n * (2 * D * size + 2 * Fl * 8
                                                  + Fl * size):
        # an expert's weights gathered at a time where there is a gather
        out = []
        for e in range(El) if fsdp else (None,):
            part = slice(None) if e is None else slice(e, e + 1)
            w = {k: lay.param(params[k][part], descr[k])
                 for k in ("wi", "wg", "wo")}
            up = torch.bmm(h[part], w["wi"])
            gset = torch.bmm(h[part], w["wg"])
            out.append(torch.bmm(F.silu(gset) * up, w["wo"]))
        return torch.cat(out) if len(out) > 1 else out[0]
    w = {k: lay.local(params[k], descr[k], fsdp) for k in ("wi", "wg", "wo")}
    j = C.axis_index(lay.mesh, fsdp)
    Dl = D // nd
    # every rank's rows on this rank's width block, the partial products
    # summed back to each rank's rows
    hd = sharded.gather_blocks(h, lay.mesh, 1, dims=fsdp)[..., j * Dl:
                                                          (j + 1) * Dl]
    up = sharded.reduce_scatter(torch.bmm(hd, w["wi"]), lay.mesh, 1,
                                dims=fsdp)
    gset = sharded.reduce_scatter(torch.bmm(hd, w["wg"]), lay.mesh, 1,
                                  dims=fsdp)
    act = sharded.gather_blocks(F.silu(gset) * up, lay.mesh, 1, dims=fsdp)
    cols = sharded.gather_blocks(torch.bmm(act, w["wo"]), lay.mesh, -1,
                                 dims=fsdp)
    return cols[:, j * n:(j + 1) * n]
