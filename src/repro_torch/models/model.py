"""The reference's unified transformer: rwkv blocks (rwkv6-3b), RG-LRU
blocks and sliding-window "local" attention blocks (recurrentgemma-9b,
gemma2-27b), dense attention blocks (llama3.2-3b, yi-6b, gemma-7b,
qwen2-vl-72b with M-RoPE), attention blocks whose feed-forward is a
mixture of experts (grok-1-314b, llama4-maverick-400b-a17b), and the
encoder-decoder of whisper-tiny: an encoder over precomputed frame
embeddings (the audio frontend is a stub, as in the reference) with
sinusoidal positions and non-causal blocks, and decoder blocks that
cross-attend to its output (`memory`) after their self-attention.

The reference stacks each homogeneous group of layers and scans over
it; here `Transformer` is an `nn.Module` holding one block per layer in
a `ModuleList` ("blocks", and "encoder.blocks"), and the stack is a
Python loop.  Every descriptor carries the reference's partition spec
(the stacked groups' leading None dropped): `Transformer.specs()`.

Under a mesh (`launch.mesh.set_mesh`), `forward`, `loss_fn`,
`init_cache` and `decode_step` called with `dp=` (the data-parallel
dims; the default is ("data",), as the reference's) run sharded as
explicit SPMD (`models.sharded`): `params` are this rank's blocks
(`sharded.shard_params` under `param_specs`), the batch is this rank's
rows, the hidden state between residual updates is the rank's block
(B/dp, S, D/m) where "model" divides d_model (the reference's
`_constrain` to P(dp, None, "model"); `sharded.Layout.for_hidden`),
else (B/dp, S, D) replicated, and the logits come back as this rank's
vocabulary block (B/dp, S, V/m).  Decode keeps the hidden state
replicated, as the reference constrains nothing there.  Every block
kind shards: attention ("attn", "local", for any head count), rwkv,
RG-LRU, the mixtures of experts (`models.moe`) and the encoder-decoder,
whose encoder runs on the rank's rows of frames and whose
cross-attentions read that memory.  Without a mesh,
or with `dp=None`, everything runs unsharded.

Training (`loss_fn`) runs the same blocks with gradients on, each
block recomputed in backward when `cfg.remat`, through differentiable
routes only: `full_attention`, `banded_local_attention` for local
layers beyond their window, `chunked_attention` beyond
`chunk_threshold` keys, the chunked plain wkv recurrence, the RG-LRU's
doubling scan and the MoE dispatch.  The forward-only kernels raise
under autograd.

`params` is a `Transformer`, or the same parameters as a flat dict of
tensors under their `named_parameters` names (`param_dict`), as the
train state holds them, or that dict nested.

Entry points:
  Transformer(cfg)                    — parameters on the meta device,
                                        `num_params`, `.init(seed, device)`,
                                        `.specs()`, `.abstract()`
  forward(params, cfg, batch, dp=)    — logits (prefill); batch carries
                                        "frames" for whisper
  loss_fn(params, cfg, batch, dp=)    — mean next-token CE (training)
  init_cache / decode_step (dp=)      — single-token serving (whisper:
                                        `init_cache(frames=)` encodes)
  init_paged_cache / paged_decode_step — continuous batching over a
                                        paged KV cache
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._tf32 import no_tf32
from ..core.options import resolve_device
from ..dist import collectives as C
from . import sharded
from .attention import (
    attention, attn_params, decode_attention, init_kv_cache,
    init_paged_kv_cache, paged_decode_attention,
)
from .config import ModelConfig
from .layers import (
    DTYPES, P_, abstract_tree, count_params, dense, layer_norm, mlp,
    mlp_params, rms_norm, spec_tree,
)
from .moe import moe_ffn, moe_params
from .rglru import init_rglru_state, rglru_block, rglru_decode, rglru_params
from .rwkv import (
    init_rwkv_state, rwkv_channel_mix, rwkv_channel_mix_decode, rwkv_params,
    rwkv_time_mix, rwkv_time_mix_decode,
)

__all__ = ["Transformer", "forward", "loss_fn", "init_cache", "decode_step",
           "init_paged_cache", "paged_decode_step", "model_params",
           "param_dict", "param_specs", "DP_DEFAULT"]

DP_DEFAULT = ("data",)

# --------------------------- parameter tree ---------------------------


def _norm_params(cfg: ModelConfig, kind: str) -> dict:
    D = cfg.d_model
    if kind == "rwkv":  # LayerNorm with bias
        return {
            "scale": P_((D,), init="ones", dtype="float32", spec=("model",)),
            "bias": P_((D,), init="zeros", dtype="float32", spec=("model",)),
        }
    return {"scale": P_((D,), init="zeros", dtype="float32",
                        spec=("model",))}


def _apply_norm(p, cfg: ModelConfig, x, lay=None):
    """The norm of `p` over the whole of x; under a layout its scale is
    gathered whole, and so is x where the hidden state is split
    (`Layout.enter`)."""
    if lay is not None:
        d = _norm_params(cfg, "rwkv" if "bias" in p else "attn")
        p = {k: lay.whole(p[k], d[k]) for k in d}
        x = lay.enter(x)
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def block_params(cfg: ModelConfig, kind: str, *, cross: bool = False,
                 model_axis: int = 16) -> dict:
    """One block's descriptors; `cross` adds an attention block's
    cross-attention ("xattn") and its norm ("lnx").  `model_axis` picks
    the MoE experts' specs."""
    d: dict = {"ln1": _norm_params(cfg, kind), "ln2": _norm_params(cfg, kind)}
    if kind in ("attn", "local"):
        d["attn"] = attn_params(cfg)
        if cross:
            d["xattn"] = attn_params(cfg, cross=True)
            d["lnx"] = _norm_params(cfg, kind)
        if cfg.num_experts:
            d["moe"] = moe_params(cfg, model_axis)
        else:
            d["mlp"] = mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp_kind)
        if cfg.post_norms:
            d["post1"] = _norm_params(cfg, kind)
            d["post2"] = _norm_params(cfg, kind)
    elif kind == "rglru":
        d["rglru"] = rglru_params(cfg)
        d["mlp"] = mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp_kind)
    elif kind == "rwkv":
        d.update(rwkv_params(cfg))
    else:
        raise ValueError(kind)
    return d


def _head_params(cfg: ModelConfig) -> dict:
    """The embedding (vocabulary over "model") and the untied
    unembedding's descriptors."""
    V, D = cfg.vocab_size, cfg.d_model
    tree = {"embed": P_((V, D), init="embed", spec=("model", "data"))}
    if not cfg.tie_embeddings:
        tree["unembed"] = P_((D, V), spec=("data", "model"))
    return tree


def model_params(cfg: ModelConfig, model_axis: int = 16) -> dict:
    """The descriptor tree: embed, final_norm, unembed (untied only),
    one block per layer under "blocks" (with cross-attention in an
    encoder-decoder) and, for an encoder-decoder, "encoder": its blocks
    and final norm.  `model_axis` picks the MoE experts' specs."""
    head = _head_params(cfg)
    tree: dict = {"embed": head.pop("embed"),
                  "final_norm": _norm_params(cfg, "attn")} | head
    cross = cfg.encoder_layers > 0
    tree["blocks"] = [block_params(cfg, kind, cross=cross,
                                   model_axis=model_axis)
                      for kind in cfg.layer_kinds()]
    if cross:
        tree["encoder"] = {
            "blocks": [block_params(cfg, "attn", model_axis=model_axis)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": _norm_params(cfg, "attn")}
    return tree


def param_specs(cfg: ModelConfig, mesh=None, model_axis: int = 16) -> dict:
    """{parameter name: spec}, sanitized against `mesh` (a `DeviceMesh`
    or a name-to-size mapping) when one is given."""
    descr = dict(flat_tree(model_params(cfg, model_axis)))
    if mesh is None:
        return {k: d.spec for k, d in descr.items()}
    return {k: sharded.sanitize_spec(d.spec, d.shape, mesh)
            for k, d in descr.items()}


def _meta(tree, dtype):
    """Parameters (on the meta device: nothing is allocated) in the shape
    of a descriptor tree: a `ParameterDict` for a dict of leaves, a
    `ModuleDict` or `ModuleList` above."""
    if isinstance(tree, P_):
        return nn.Parameter(
            torch.empty(tree.shape, dtype=tree.resolve_dtype(dtype),
                        device="meta"), requires_grad=False)
    if isinstance(tree, list):
        return nn.ModuleList([_meta(t, dtype) for t in tree])
    if all(isinstance(v, P_) for v in tree.values()):
        return nn.ParameterDict({k: _meta(v, dtype) for k, v in tree.items()})
    return nn.ModuleDict({k: _meta(v, dtype) for k, v in tree.items()})


def flat_tree(tree, prefix=""):
    """(dotted name, leaf) of a tree of dicts and lists, named as
    `named_parameters` names the parameters built from it."""
    if not isinstance(tree, (dict, list)):
        yield prefix[:-1], tree
        return
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        yield from flat_tree(v, f"{prefix}{k}.")


def param_dict(params) -> dict:
    """The parameters of a `Transformer` as a flat dict of tensors (no
    autograd), named as `named_parameters` names them."""
    return {name: p.detach() for name, p in params.named_parameters()}


def _nest(flat: dict) -> dict:
    """A flat dict of dotted names as the nested tree the model reads:
    dicts, with a list under "blocks" and "encoder.blocks"."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    for node in (tree, tree.get("encoder", {})):
        if "blocks" in node:
            blocks = node["blocks"]
            node["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


def _tree(params):
    """The model's view of `params`: a `Transformer` or nested dict as
    is, a flat dict nested."""
    if isinstance(params, dict) and "blocks" not in params:
        return _nest(params)
    return params


# ------------------------------ forward -------------------------------


def _block_forward(p, cfg: ModelConfig, kind: str, x, positions, *,
                   memory=None, causal: bool = True,
                   chunk_threshold: int = 2047, train: bool = False,
                   lay=None):
    """One block over a full sequence.  `chunk_threshold` is the
    attention's, self and cross (keys beyond it take the flash route or
    `chunked_attention`); `memory` (B, Se, D) feeds the block's
    cross-attention where it has one.  `lay`: the sharded layout, or
    None: x is the hidden state of its `hidden_split`."""
    if kind == "rwkv":
        x = x + rwkv_time_mix(p["time"], cfg,
                              _apply_norm(p["ln1"], cfg, x, lay),
                              train=train, lay=lay)
        return x + rwkv_channel_mix(p["channel"], cfg,
                                    _apply_norm(p["ln2"], cfg, x, lay),
                                    lay=lay)
    if kind == "rglru":
        x = x + rglru_block(p["rglru"], cfg,
                            _apply_norm(p["ln1"], cfg, x, lay), lay=lay)
        return x + _mlp(p["mlp"], cfg, _apply_norm(p["ln2"], cfg, x, lay),
                        lay)
    h = attention(p["attn"], cfg, _apply_norm(p["ln1"], cfg, x, lay),
                  positions, kind=kind, causal=causal,
                  chunk_threshold=chunk_threshold, train=train, dp=lay)
    return _attn_block_rest(p, cfg, x, h, memory, positions, lay=lay,
                            chunk_threshold=chunk_threshold, train=train)


def _attn_block_rest(p, cfg: ModelConfig, x, h, memory=None, positions=None,
                     lay=None, **cross):
    """An attention block after its attention output `h`: the residual;
    where the block has a cross-attention and `memory` is given, that
    attention's residual (queries at `positions`, `attention`'s keywords
    `cross`); then the feed-forward's (the MLP, or the MoE), each with
    its post-norm where the config has them.  Under a layout each
    branch output is the hidden state's (`Layout.leave`); a post-norm
    normalises it whole and splits it back (`Layout.part`)."""
    if cfg.post_norms:
        h = _post_norm(p["post1"], cfg, h, lay)
    x = x + h
    if memory is not None and "xattn" in p:
        x = x + attention(p["xattn"], cfg, _apply_norm(p["lnx"], cfg, x, lay),
                          positions, memory=memory, dp=lay, **cross)
    z = _apply_norm(p["ln2"], cfg, x, lay)
    h = (moe_ffn(p["moe"], cfg, z, dp=lay) if cfg.num_experts
         else _mlp(p["mlp"], cfg, z, lay))
    if cfg.post_norms:
        h = _post_norm(p["post2"], cfg, h, lay)
    return x + h


def _post_norm(p, cfg: ModelConfig, h, lay=None):
    """A branch output's post-norm: as the hidden state is laid out."""
    h = _apply_norm(p, cfg, h, lay)
    return h if lay is None else lay.part(h)


def _mlp(p, cfg: ModelConfig, z, lay=None):
    """The dense MLP of the whole z; under a layout, column-parallel wi /
    wg and row-parallel wo over "model", the output the hidden state's
    (`Layout.leave`); replicated where "model" does not divide d_ff."""
    if lay is None:
        return mlp(z, p, cfg.mlp_kind)
    descr = mlp_params(cfg.d_model, cfg.d_ff, cfg.mlp_kind)
    w = lay.params(p, descr)
    if not lay.split(descr["wi"]):
        return lay.part(mlp(z, w, cfg.mlp_kind))
    return lay.leave(mlp(lay.copy(z), w, cfg.mlp_kind))


def _embed(params, cfg: ModelConfig, tokens, lay=None):
    """The tokens' embeddings.  Under a layout the rank looks up its
    vocabulary block (zeros for ids outside it) and the blocks are
    summed over "model", which is exact, into the hidden state's layout
    (`Layout.leave`; `Layout.part` of an unsplit vocabulary's lookup).
    The block's width is split over "data" (FSDP): where the tokens of
    the ranks along it are fewer than the block's rows, they are
    gathered instead of the weight, the rank looks them all up in its
    columns and the looked-up columns are
    gathered (each rank's gradient summed in backward); else the block
    is gathered whole."""
    if lay is None:
        e = params["embed"][tokens]
    else:
        d = _head_params(cfg)["embed"]
        fsdp = lay.fsdp_dims(d, 1)
        n = C.axis_size(lay.mesh, fsdp)
        Vl = params["embed"].shape[0]
        if fsdp and tokens.numel() * n < Vl:
            E = lay.local(params["embed"], d, fsdp)
            rows = C.all_gather(tokens, lay.mesh, fsdp)
        else:
            E, rows = lay.param(params["embed"], d), tokens
        if lay.split(d):
            local = rows - lay.model_index() * Vl
            inside = ((local >= 0) & (local < Vl))[..., None]
            e = E[local.clamp(0, Vl - 1)]
            e = torch.where(inside, e, torch.zeros_like(e))
        else:
            e = E[rows]
        if rows is not tokens:
            e = sharded.gather_blocks(e, lay.mesh, -1, dims=fsdp).narrow(
                0, C.axis_index(lay.mesh, fsdp) * tokens.shape[0],
                tokens.shape[0])
        e = lay.leave(e) if lay.split(d) else lay.part(e)
    if cfg.scale_embeddings:
        e = e * torch.tensor(cfg.d_model**0.5, dtype=e.dtype)
    return e.to(DTYPES[cfg.dtype])


def _unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        # bf16 products are exact in f32: this is an f32-accumulated dot
        logits = x.float() @ params["embed"].float().T
    else:
        logits = dense(x, params["unembed"]).float()
    return _finish_logits(cfg, logits)


def _finish_logits(cfg: ModelConfig, logits):
    """The head's product `logits` (f32) scaled (tied) and softcapped."""
    if cfg.tie_embeddings:
        # the reference's tied-head scaling for its unit-variance embed
        logits = logits * cfg.d_model**-0.5
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _head(params, cfg: ModelConfig, lay):
    """(the unembedding's weights as `_unembed` reads them, whether the
    vocabulary is split over "model"): as they are, or under a layout
    this rank's vocabulary block gathered over the dp dims."""
    if lay is None:
        return params, False
    name = "embed" if cfg.tie_embeddings else "unembed"
    d = _head_params(cfg)[name]
    return {name: lay.param(params[name], d)}, lay.split(d)


def _logits(params, cfg: ModelConfig, x, lay=None):
    """f32 logits of the hidden state x: (B, S, V), or under a layout
    this rank's block (B/dp, S, V/m).  Where the hidden states of the
    ranks along the dp dims that split the head's width hold fewer
    elements than its gathered block (a decode step), they are gathered
    instead: the rank multiplies all their rows by its block's columns
    and the products are reduce-scattered back to each rank's rows."""
    if lay is not None:
        name = "embed" if cfg.tie_embeddings else "unembed"
        d = _head_params(cfg)[name]
        wide = 1 if cfg.tie_embeddings else 0      # the width's dim
        fsdp = lay.fsdp_dims(d, wide)
        n = C.axis_size(lay.mesh, fsdp)
        D, Vl = cfg.d_model, params[name].shape[1 - wide]
        if fsdp and x.shape[0] * x.shape[1] * n * (D + Vl) < Vl * D:
            w = lay.local(params[name], d, fsdp)
            xs = lay.copy(x) if lay.split(d) else x
            xs = sharded.gather_blocks(xs, lay.mesh, 0, dims=fsdp)
            xs = xs.narrow(-1, C.axis_index(lay.mesh, fsdp) * (D // n),
                           D // n).float()
            part = xs @ (w.float().T if cfg.tie_embeddings else w.float())
            logits = sharded.reduce_scatter(part, lay.mesh, 0, dims=fsdp)
            if not cfg.tie_embeddings:
                logits = logits.to(x.dtype).float()  # `dense`'s rounding
            return _finish_logits(cfg, logits)
    w, split = _head(params, cfg, lay)
    return _unembed(w, cfg, lay.copy(x) if split else x)


def _tokens(params, tokens):
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _positions(cfg: ModelConfig, batch: dict, tokens):
    """The batch's (B, S, 3) M-RoPE ids, or None: positions 0..S-1 in
    every row, which the attention's flash route takes."""
    if cfg.mrope_sections is not None:
        return torch.as_tensor(batch["positions"], device=tokens.device)
    return None


def _blocks(blocks, kinds, cfg: ModelConfig, x, positions, *, memory=None,
            causal: bool = True, train: bool = False, lay=None):
    """A stack of blocks, each recomputed in backward when `train` and
    `cfg.remat`, which then saves its input x: the rank's block under a
    layout that splits the hidden state."""
    for p, kind in zip(blocks, kinds):
        if train and cfg.remat:
            x = checkpoint(_train_block, p, cfg, kind, x, positions, memory,
                           causal, lay, use_reentrant=False)
        else:
            x = _block_forward(p, cfg, kind, x, positions, memory=memory,
                               causal=causal, train=train, lay=lay)
    return x


def _train_block(p, cfg, kind, x, positions, memory, causal, lay):
    return _block_forward(p, cfg, kind, x, positions, memory=memory,
                          causal=causal, train=True, lay=lay)


def _encode(params, cfg: ModelConfig, frames, *, train: bool = False,
            lay=None):
    """The whisper encoder over precomputed frame embeddings (B, Se, D)
    (the stub frontend): sinusoidal positions added in f32, then the
    non-causal self-attention blocks (rotary at 0..Se-1, as the
    reference applies it) and the encoder's final norm.  None for a
    decoder-only config.  Under a layout, on this rank's rows of frames,
    the hidden state laid out as the decoder's (`Layout.for_hidden`);
    the memory, gathered by the final norm, comes back replicated over
    "model"."""
    if not cfg.encoder_layers:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs "
                         f"frames (B, {cfg.encoder_seq}, {cfg.d_model})")
    enc = params["encoder"]
    frames = torch.as_tensor(frames, device=params["embed"].device)
    S, D = frames.shape[1:]
    half = D // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=frames.device)
                     * (9.21 / max(half - 1, 1)))
    ang = torch.arange(S, dtype=torch.float32,
                       device=frames.device)[:, None] * freq[None]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    x = (frames.float() + pe[None]).to(DTYPES[cfg.dtype])
    if lay is not None:
        lay = lay.for_hidden(cfg)
        x = lay.part(x)
    x = _blocks(enc["blocks"], ("attn",) * len(enc["blocks"]), cfg, x, None,
                causal=False, train=train, lay=lay)
    return _apply_norm(enc["final_norm"], cfg, x, lay)


def _hidden(params, cfg: ModelConfig, batch: dict, *, train: bool = False,
            lay=None):
    """Backbone through the final norm (pre-unembed), the encoder first
    for an encoder-decoder.  With `train`, the blocks take the
    differentiable routes, each recomputed in backward when
    `cfg.remat`.  Under a layout `lay` (`sharded.layout`), the hidden
    state laid out by `Layout.for_hidden` and this rank's rows (B/dp, S,
    D) returned whole, replicated over "model" (the final norm gathers
    them)."""
    lay = None if lay is None else lay.for_hidden(cfg)
    tokens = _tokens(params, batch["tokens"])
    positions = _positions(cfg, batch, tokens)
    memory = _encode(params, cfg, batch.get("frames"), train=train, lay=lay)
    x = _embed(params, cfg, tokens, lay)
    x = _blocks(params["blocks"], cfg.layer_kinds(), cfg, x, positions,
                memory=memory, train=train, lay=lay)
    return _apply_norm(params["final_norm"], cfg, x, lay)


def forward(params, cfg: ModelConfig, batch: dict, *, dp=DP_DEFAULT):
    """batch: tokens (B,S) [+ positions (B,S,3) for M-RoPE, + frames
    (B,Se,D) for an encoder-decoder].  Returns fp32 logits (B,S,V).

    Under a mesh with `dp` (module docstring): `params` are this rank's
    blocks, the batch its rows, and the logits its block (B/dp, S, V/m)
    (`sharded.gather_act` assembles them)."""
    params = _tree(params)
    lay = sharded.layout(cfg, dp)
    with no_tf32(), torch.no_grad():
        return _logits(params, cfg, _hidden(params, cfg, batch, lay=lay),
                       lay)


def _chunk_nll(params, cfg, xc, lc, lay=None, start=None):
    """(summed NLL, count) of one chunk of positions; labels < 0 are
    masked.  With a vocabulary block's first id `start` (a layout whose
    "model" dim splits the vocabulary), `params` hold that block and the
    NLL is `sharded.vocab_parallel_nll`'s."""
    logits = _unembed(params, cfg, xc)                      # (B, c, V) f32
    mask = (lc >= 0).float()
    safe = lc.clamp_min(0)
    if start is not None:
        nll = sharded.vocab_parallel_nll(logits, safe, lay.mesh, start)
    else:
        gold = logits.gather(-1, safe[..., None])[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - gold
    return (nll * mask).sum(), mask.sum()


def loss_fn(params, cfg: ModelConfig, batch: dict, *, loss_chunk: int = 512,
            dp=DP_DEFAULT):
    """Mean next-token cross-entropy; labels < 0 are masked.  Gradients
    flow to whichever parameter tensors require them.

    The f32 logits never materialize for the whole sequence: unembed and
    CE run over chunks of `loss_chunk` positions, each recomputed in
    backward, as the reference's scan under `jax.checkpoint` does (at
    vocab 128256 one chunk of 512 is 0.26 GB of logits a row).  f32
    products run in full f32 (no TF32).

    Under a mesh with `dp`: `params` are this rank's blocks and the batch
    its rows.  The hidden state comes whole out of the final norm, which
    gathers it once before the chunks.  The NLL is vocabulary-parallel;
    each rank divides its sum by the global count of unmasked labels, so
    the gradients (this rank's blocks, summed over the dp dims in
    backward) are the global mean's; the loss returned is the global
    mean on every rank.
    """
    params = _tree(params)
    lay = sharded.layout(cfg, dp)
    with no_tf32():
        x = _hidden(params, cfg, batch, train=True, lay=lay)
        labels = torch.as_tensor(batch["labels"], device=x.device).long()
        B, S, D = x.shape
        c = min(loss_chunk, S)
        pad = (-S) % c
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        w, split = _head(params, cfg, lay)
        start = None
        if split:
            x = lay.copy(x)
            start = lay.model_index() * (cfg.vocab_size // lay.m)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(0, S + pad, c):
            s, m = checkpoint(_chunk_nll, w, cfg, x[:, t:t + c],
                              labels[:, t:t + c], lay, start,
                              use_reentrant=False)
            nll = nll + s
            cnt = cnt + m
        if lay is None:
            return nll / cnt.clamp_min(1.0)
        cnt = C.psum(cnt.detach(), lay.mesh, lay.dp)
        return sharded.reduce_from(nll / cnt.clamp_min(1.0), lay.mesh,
                                   lay.dp)


# ------------------------------ serving -------------------------------


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               frames=None, *, dp=DP_DEFAULT) -> dict:
    """Per-layer decode state on the parameters' device.  `max_len` is
    the attention cache length; recurrent layers keep O(1) state.  An
    encoder-decoder encodes `frames` (B, Se, D) once here: its output is
    the cache's "memory", which every decode step cross-attends to
    (None for a decoder-only config).

    Under a mesh with `dp`, `batch` counts this rank's rows, and each
    leaf is this rank's block under the reference's cache rule
    (`sharded.cache_spec`): an attention layer's Hkv/m KV heads, or
    where "model" does not divide them its block of every head's
    positions; the rwkv state whole, the token-shift, conv and RG-LRU
    buffers the rank's channels; the memory is encoded from the rank's
    rows of `frames`, replicated over "model"."""
    params = _tree(params)
    device = params["embed"].device
    lay = sharded.layout(cfg, dp)
    with no_tf32(), torch.no_grad():
        memory = _encode(params, cfg, frames, lay=lay)
    return {
        "layers": [layer_state(cfg, kind, batch, max_len, device)
                   if lay is None else
                   _local_state(cfg, kind, batch, max_len, device, lay)
                   for kind in cfg.layer_kinds()],
        "step": 0,
        "memory": memory,
    }


def _local_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device, lay) -> dict:
    """This rank's blocks over "model" of one layer's empty decode state
    for `batch` rows (`init_cache`)."""
    out = {}
    for name, a in layer_state(cfg, kind, batch, max_len, "meta").items():
        spec = sharded.cache_spec(name, tuple(a.shape), lay.sizes, lay.dp)
        shape = sharded.local_block(a, lay.mesh, spec, keep=("model",)).shape
        out[name] = torch.full(shape, -1 if name == "pos" else 0,
                               dtype=a.dtype, device=device)
    return out


def layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                device) -> dict:
    """One layer's empty decode state: a KV cache for attention (a
    rotating one of the window for "local"), the recurrent state for
    rwkv and rglru."""
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device)
    return init_kv_cache(cfg, kind, batch, max_len, device)


def _block_decode(p, cfg: ModelConfig, kind: str, x, state, step: int,
                  memory=None, lay=None):
    if kind == "rwkv":
        h, new_t = rwkv_time_mix_decode(
            p["time"], cfg, _apply_norm(p["ln1"], cfg, x, lay), state, lay)
        x = x + h
        h, new_c = rwkv_channel_mix_decode(
            p["channel"], cfg, _apply_norm(p["ln2"], cfg, x, lay), new_t, lay)
        return x + h, new_c
    if kind == "rglru":
        h, new = rglru_decode(p["rglru"], cfg,
                              _apply_norm(p["ln1"], cfg, x, lay), state, lay)
        x = x + h
        return x + _mlp(p["mlp"], cfg, _apply_norm(p["ln2"], cfg, x, lay),
                        lay), new
    h, new = decode_attention(p["attn"], cfg,
                              _apply_norm(p["ln1"], cfg, x, lay), state,
                              step, kind=kind, dp=lay)
    at = (None if memory is None  # the token's position, for its cross
          else torch.full((x.shape[0], 1), int(step), device=x.device))
    return _attn_block_rest(p, cfg, x, h, memory, at, lay=lay), new


def decode_step(params, cfg: ModelConfig, cache: dict, tokens, *,
                dp=DP_DEFAULT):
    """One serving step: tokens (B,) -> logits (B, V), updated cache.
    Attention layers write their KV cache in place; an encoder-decoder's
    blocks cross-attend to the cache's memory, their k and v projected
    from it each step.  Under a mesh with `dp`: this rank's rows of
    tokens and cache (its memory too), and its logits block
    (B/dp, V/m)."""
    step, memory = cache["step"], cache.get("memory")
    params = _tree(params)
    lay = sharded.layout(cfg, dp)
    with no_tf32(), torch.no_grad():
        x = _embed(params, cfg, _tokens(params, tokens)[:, None], lay)
        layers = []
        for p, kind, state in zip(params["blocks"], cfg.layer_kinds(),
                                  cache["layers"]):
            x, new = _block_decode(p, cfg, kind, x, state, step, memory, lay)
            layers.append(new)
        x = _apply_norm(params["final_norm"], cfg, x, lay)
        logits = _logits(params, cfg, x, lay)[:, 0]
    return logits, {"layers": layers, "step": step + 1, "memory": memory}


# --------------------------- paged serving ----------------------------


def init_paged_cache(params, cfg: ModelConfig, num_slots: int,
                     num_pages: int, page_size: int) -> dict:
    """Decode state of the paged (continuous-batching) path on the
    parameters' device: one page pool per attention layer (plus its
    trash page, `attention.init_paged_kv_cache`; "local" layers too,
    masked by the window), per-slot recurrent state for rwkv and rglru
    layers, which the step zeroes at a fresh admission.
    Encoder-decoder configs are not paged: their decode state is
    per-request memory, not a KV pool."""
    if cfg.encoder_layers:
        raise ValueError(
            "paged serving supports decoder-only configs; "
            f"{cfg.name} has encoder layers")
    device = params["embed"].device
    return {"layers": [
        init_paged_kv_cache(cfg, num_pages, page_size, device)
        if kind in ("attn", "local")
        else layer_state(cfg, kind, num_slots, 0, device)
        for kind in cfg.layer_kinds()]}


def _slot_mask(m, a):
    """`m` (B,) broadcast against a per-slot state `a` whose leading axis
    is B, or B*H (the wkv state (B*H, N, N): each slot's mask repeated
    for its H heads)."""
    if a.shape[0] != m.shape[0]:
        m = torch.repeat_interleave(m, a.shape[0] // m.shape[0])
    return m.reshape((-1,) + (1,) * (a.dim() - 1))


def _block_decode_paged(p, cfg: ModelConfig, kind: str, x, state,
                        page_map, steps, write_mask):
    if kind in ("attn", "local"):
        h, new = paged_decode_attention(
            p["attn"], cfg, _apply_norm(p["ln1"], cfg, x), state, page_map,
            steps, write_mask, kind=kind)
        return _attn_block_rest(p, cfg, x, h), new
    # recurrent layers: zero a slot's state at the first token of a fresh
    # admission (the initial state is zeros, so a reused slot cannot leak
    # the previous request's recurrence), run the dense decode body, then
    # hold back the updates of slots that do not write
    fresh = write_mask & (steps == 0)
    state = {k: torch.where(_slot_mask(fresh, a), torch.zeros_like(a), a)
             for k, a in state.items()}
    h, new = _block_decode(p, cfg, kind, x, state, 0)
    return h, {k: torch.where(_slot_mask(write_mask, a), a, state[k])
               for k, a in new.items()}


def paged_decode_step(params, cfg: ModelConfig, cache: dict, tokens,
                      page_map, steps, write_mask):
    """One continuous-batching step: every slot decodes its own position.

    tokens (B,) the current token of each slot; page_map (B, P) int
    physical pages (the trash page where none is held); steps (B,) int
    each slot's absolute position; write_mask (B,) bool, which slots
    write their KV and update their recurrent state.  Host arrays or
    tensors.  Returns (logits (B, V) f32, the cache): attention pools
    are written in place, recurrent state comes back new.

    Per live slot the same arithmetic as `decode_step`: with ``P *
    page_size`` equal to the dense cache's `max_len` the logits are
    bitwise the dense path's.  Masked slots write the trash page and
    keep their state, so one step serves any admit / retire pattern.
    """
    params = _tree(params)
    dev = params["embed"].device
    page_map = torch.as_tensor(page_map, device=dev)
    steps = torch.as_tensor(steps, device=dev)
    write_mask = torch.as_tensor(write_mask, device=dev).to(torch.bool)
    with no_tf32(), torch.no_grad():
        x = _embed(params, cfg, _tokens(params, tokens)[:, None])
        layers = []
        for p, kind, state in zip(params["blocks"], cfg.layer_kinds(),
                                  cache["layers"]):
            x, new = _block_decode_paged(p, cfg, kind, x, state, page_map,
                                         steps, write_mask)
            layers.append(new)
        x = _apply_norm(params["final_norm"], cfg, x)
        logits = _unembed(params, cfg, x)[:, 0]
    return logits, {"layers": layers}


# ------------------------------ facade --------------------------------


class Transformer(nn.Module):
    """The model's parameters as modules, built on the meta device (no
    memory): `num_params` needs nothing more, `init` materializes them
    on a device from a seed.  `forward(batch)` is `forward(self, cfg,
    batch)`."""

    def __init__(self, cfg: ModelConfig, model_axis: int = 16):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.model_axis = model_axis
        self.descr = model_params(cfg, model_axis)
        dtype = DTYPES[cfg.dtype]
        for name, sub in self.descr.items():
            setattr(self, name, _meta(sub, dtype))

    def __getitem__(self, name: str):
        """The top-level parameters and modules by name, as the model's
        functions read a nested dict of parameters."""
        return getattr(self, name)

    @property
    def num_params(self) -> int:
        return count_params(self.descr)

    def specs(self) -> dict:
        """{parameter name: partition spec}, as `named_parameters` names
        the parameters (`spec_tree` of the descriptors, flattened)."""
        return dict(flat_tree(spec_tree(self.descr)))

    def abstract(self) -> dict:
        """{parameter name: meta tensor} of the parameters' global shapes
        and dtypes; nothing is allocated."""
        return dict(flat_tree(abstract_tree(self.descr,
                                            DTYPES[self.cfg.dtype])))

    def init(self, seed: int = 0, device="cuda") -> "Transformer":
        """Allocate the parameters on `device` (the card unless "cpu" is
        asked for) and draw them from `torch.Generator(seed)`: standard
        normals times each descriptor's std, in parameter order.  The
        draws are not jax.random's."""
        dev = resolve_device(device)
        self.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        descr = dict(flat_tree(self.descr))
        for name, param in self.named_parameters():
            descr[name].initialize_(param.data, gen)
        return self

    def forward(self, batch: dict):
        return forward(self, self.cfg, batch)
