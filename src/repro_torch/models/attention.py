"""Attention for the serving and training paths: GQA/MQA, RoPE /
M-RoPE, logit softcap, sliding windows ("local" layers),
cross-attention over an encoder's memory (whisper), the full-sequence
(prefill and training) attention and the KV-cache decode.

`attention` routes as the reference does, with the flash kernel where
it applies:

* a causal "local" self-attention over more keys than its window:
  serving at `positions=None` runs the `flash_attention` op with the
  window (the CUDA kernel on the card, its plain version on the CPU);
  training, or serving at explicit positions, runs
  `banded_local_attention`;
* otherwise, over more than `chunk_threshold` keys: serving
  self-attention at `positions=None` runs the flash op; everything else
  (training, explicit or M-RoPE positions, cross-attention) runs
  `chunked_attention`, the reference's online softmax over key chunks;
* otherwise `full_attention`, the masks as an additive bias.

The flash kernel masks by index (query i and key j from 0) where the
reference masks by position, so it takes only `positions=None`, which
means 0..S-1 in every row, as `models.model._hidden` passes it for
every config without M-RoPE; it is forward only.  `chunked_attention`,
`banded_local_attention` and `full_attention` are plain differentiable
tensor code, as the reference computes them outside any kernel, and so
is all of decode.

The paged decode (`init_paged_kv_cache`, `paged_decode_attention`)
serves continuous batching: each layer's KV lives in a pool of pages
that a `serve.PageTable` hands to decode slots, and every slot decodes
at its own position.  It is plain tensor code too, as in the reference.

The functions take `params` as any mapping of name to tensor: a dict,
or the `ParameterDict` of a `models.model.Transformer` block.

Under a mesh (`launch.mesh.set_mesh`) and with `dp=`, `attention` and
`decode_attention` run sharded (`models.sharded`): `params` hold this
rank's blocks, gathered over the data-parallel dims at use, and the
output projection's partial sums are added over "model": into the
rank's block of D where the layout splits the hidden state
(`Layout.leave`, `attention` on the `forward` / `loss_fn` route), else
whole (decode).  Where "model"
divides the KV heads, the rank computes its H/m query and Hkv/m KV
heads (a config view with `head_dim` pinned to the model's head width,
so the flash route launches the kernel on the rank's heads) and its
cache holds those heads.  Where it does not, q, k and v are gathered
into whole heads and the rank attends over its share of the (row, query
head) units, each unit one batch entry of the route's call with its KV
head, so the flash kernel's index masks stay whole-sequence; its cache
holds its block of every KV head's positions, and decode combines the
ranks' partial softmaxes (flash-decode).  A cross-attention follows the
same two rules, its k and v projected from the memory (this rank's
rows, replicated over "model"), without rotary or mask; a decode step
recomputes them from the memory, as the reference does.  The
reference's `_constrain_heads` is not ported: that layout is written
out here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import collectives as C
from ..kernels.flash_attention import flash_attention
from . import sharded
from .config import ModelConfig
from .layers import DTYPES, P_, dense, mrope, rope

__all__ = ["attn_params", "attention", "full_attention", "chunked_attention",
           "banded_local_attention", "decode_attention", "init_kv_cache",
           "init_paged_kv_cache", "paged_decode_attention"]

_NEG_INF = -1e30


def attn_params(cfg: ModelConfig, cross: bool = False) -> dict:
    """q, k, v and output projections; a cross-attention (`cross`) has
    the same shapes."""
    D, H, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_width
    return {
        "wq": P_((D, H * dh), spec=("data", "model")),
        "wk": P_((D, Hkv * dh), spec=("data", "model")),
        "wv": P_((D, Hkv * dh), spec=("data", "model")),
        "wo": P_((H * dh, D), spec=("model", "data")),
    }


def _heads(x, n, dh):
    B, S, _ = x.shape
    return x.reshape(B, S, n, dh).transpose(1, 2)   # (B, H, S, dh)


def _unheads(x):
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _apply_rope(cfg: ModelConfig, x, positions):
    if cfg.mrope_sections is not None:
        return mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return rope(x, positions, cfg.rope_theta)


def _scale(cfg: ModelConfig) -> float:
    if cfg.query_scale is not None:
        return cfg.query_scale
    return 1.0 / math.sqrt(cfg.head_width)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """(..., Sq, Sk) additive f32 bias from position tensors."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(m, zero, _NEG_INF)


def full_attention(q, k, v, bias, *, softcap, scale):
    """Direct attention; q: (B,H,Sq,dh), k/v: (B,Hkv,Sk,dh)."""
    B, H, Sq, dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float() * scale, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias[:, None, None] if bias.dim() == 3 else s + bias
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, dh).to(q.dtype)


def _chunk_step(m, l, acc, qf, kb, vb, kpb, q_pos, causal, window, softcap):
    """One key chunk of the online softmax: the carry (m, l, acc) in f32
    updated by keys kb, values vb (B,Hkv,c,dh) at positions kpb (B,c),
    -1 for padding.  Masked scores take the finite `_NEG_INF`, so a row
    with no kept key so far weighs its masked keys equally; the first
    kept key's alpha = 0 wipes them."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos[:, None, None, :, None]          # (B,1,1,Sq,1)
    kp = kpb[:, None, None, None, :]            # (B,1,1,1,c)
    keep = kp >= 0
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    s = torch.where(keep, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vb.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, q_pos, k_pos, *, causal, window, softcap,
                      scale, chunk: int = 1024):
    """Online-softmax attention over key chunks of `chunk`, never the
    whole score matrix.  q: (B,H,Sq,dh); k/v: (B,Hkv,Sk,dh); q_pos:
    (B,Sq); k_pos: (B,Sk).  Masks by position: keys are padded to whole
    chunks at position -1, which is masked.  With grad enabled each
    chunk step runs under `checkpoint`, recomputed in backward, so
    backward keeps no chunk's scores (the reference's
    `jax.checkpoint(step)`).  Returns q's dtype; sums in f32."""
    B, H, Sq, dh = q.shape
    _, Hkv, Sk, dv = v.shape
    g = H // Hkv
    nchunks = -(-Sk // chunk)
    pad = nchunks * chunk - Sk
    if pad:
        k, v = (F.pad(a, (0, 0, 0, pad)) for a in (k, v))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    qf = q.float().reshape(B, Hkv, g, Sq, dh) * scale
    m = torch.full((B, Hkv, g, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, dv), dtype=torch.float32,
                      device=q.device)
    for c in range(0, nchunks * chunk, chunk):
        args = (m, l, acc, qf, k[:, :, c:c + chunk], v[:, :, c:c + chunk],
                k_pos[:, c:c + chunk], q_pos, causal, window, softcap)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, dv).to(q.dtype)


def banded_local_attention(q, k, v, q_pos, k_pos, *, window, softcap, scale,
                           block: int = 1024):
    """Causal sliding-window self-attention restricted to the diagonal
    band: each block of `block` queries attends to the ceil(window /
    block) + 1 key blocks that can fall inside its window.  q: (B,H,S,dh);
    k/v: (B,Hkv,S,dh); q_pos, k_pos: (B,S).  Keys are front-padded so
    the band is a static gather; padded positions are -1 and masked."""
    B, H, Sq, dh = q.shape
    _, Hkv, Sk, dv = v.shape
    g = H // Hkv
    c = min(block, Sq)
    pad_t = (-Sq) % c
    if pad_t:
        q, k, v = (F.pad(a, (0, 0, 0, pad_t)) for a in (q, k, v))
        q_pos, k_pos = (F.pad(a, (0, pad_t), value=-1) for a in (q_pos, k_pos))
    S = q.shape[2]
    nb = S // c
    band = -(-window // c) + 1        # blocks that can meet the window
    qf = (q.float() * scale).reshape(B, Hkv, g, nb, c, dh)
    # band - 1 dummy blocks in front: padded block row i covers the
    # true blocks i - band + 1 .. i
    kb = F.pad(k.reshape(B, Hkv, nb, c, dh), (0, 0, 0, 0, band - 1, 0))
    vb = F.pad(v.reshape(B, Hkv, nb, c, dv), (0, 0, 0, 0, band - 1, 0))
    pb = F.pad(k_pos.reshape(B, nb, c), (0, 0, band - 1, 0), value=-1)
    idx = (torch.arange(nb, device=q.device)[:, None]
           + torch.arange(band, device=q.device)[None, :])   # (nb, band)
    kband = kb[:, :, idx].reshape(B, Hkv, nb, band * c, dh)
    vband = vb[:, :, idx].reshape(B, Hkv, nb, band * c, dv)
    pband = pb[:, idx].reshape(B, nb, band * c)

    s = torch.einsum("bhgncd,bhnkd->bhgnck", qf, kband.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos.reshape(B, nb, c)[:, None, None, :, :, None]
    kp = pband[:, None, None, :, None, :]
    keep = (kp >= 0) & (kp <= qp) & (kp > qp - window)
    s = torch.where(keep, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgnck,bhnkd->bhgncd", p, vband.float())
    return o.reshape(B, H, S, dv)[:, :, :Sq].to(q.dtype)


def attention(
    params,
    cfg: ModelConfig,
    x,
    positions=None,                     # None: 0..S-1 in every row
    *,
    kind: str = "attn",                 # attn | local
    causal: bool = True,
    memory=None,                        # cross-attention source (B,Sm,D)
    memory_positions=None,
    chunk_threshold: int = 2047,
    train: bool = False,
    dp=None,
):
    """Self- (or cross-) attention over a full sequence (prefill, or
    training when `train`).  `positions` is (B, S), or (B, S, 3) for
    M-RoPE; None means index positions 0..S-1, the only ones the flash
    route takes.  `memory` (B, Sm, D) makes it a cross-attention: no
    rotary on the memory, no causal mask, keys at `memory_positions`
    (0..Sm-1 unless given).

    Routes (the module docstring's table): a causal "local"
    self-attention beyond its window takes the flash op with the window
    when serving at `positions=None`, else `banded_local_attention`;
    beyond `chunk_threshold` keys, serving self-attention at
    `positions=None` takes the flash op, and training, explicit or
    M-RoPE positions and cross-attention take `chunked_attention` over
    chunks of min(1024, keys); otherwise `full_attention` with the masks
    as biases.

    `dp` (the data-parallel dims, or a `sharded.Layout`) under a mesh:
    sharded (module docstring); x (and `memory`) are this rank's rows,
    replicated over "model"; the output is the hidden state's
    (`Layout.leave`: the rank's block of D where the layout splits it,
    else replicated)."""
    lay = sharded.layout(None, dp)
    route = dict(kind=kind, causal=causal, memory=memory,
                 memory_positions=memory_positions,
                 chunk_threshold=chunk_threshold, train=train)
    if lay is None:
        return _attention(params, cfg, x, positions, **route)
    if memory is not None:
        route["memory"] = lay.copy(memory)
    if not lay.heads_divide(cfg):
        return _attention_units(params, cfg, x, positions, lay, **route)
    w = lay.params(params, attn_params(cfg))
    return lay.leave(_attention(w, lay.local_cfg(cfg), lay.copy(x),
                                positions, **route))


def _index_positions(cfg: ModelConfig, x):
    """Positions 0..S-1 in every row of x (B, S, D)."""
    if cfg.mrope_sections is not None:
        raise ValueError(f"{cfg.name}: M-RoPE needs (B, S, 3) positions")
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def _attention(params, cfg: ModelConfig, x, positions, *, kind, causal,
               memory=None, memory_positions=None, chunk_threshold, train):
    """`attention` on one device (or on this rank's heads)."""
    H, Hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_width
    index = positions is None
    if index:
        positions = _index_positions(cfg, x)
    src = x if memory is None else memory
    q = _heads(dense(x, params["wq"]), H, dh)
    k = _heads(dense(src, params["wk"]), Hkv, dh)
    v = _heads(dense(src, params["wv"]), Hkv, dh)
    if memory is None:
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)
        k_pos = positions if positions.dim() == 2 else positions[..., 0]
    else:
        # cross-attention: no rotary on encoder memory (whisper style)
        k_pos = (memory_positions if memory_positions is not None
                 else torch.arange(src.shape[1], device=src.device)
                 [None].expand(src.shape[:2]))
    q_pos = positions if positions.dim() == 2 else positions[..., 0]
    o = _attend(cfg, q, k, v, q_pos, k_pos, kind=kind, causal=causal,
                cross=memory is not None, index=index,
                chunk_threshold=chunk_threshold, train=train)
    return dense(_unheads(o), params["wo"])


def _attention_units(params, cfg: ModelConfig, x, positions, lay, *, kind,
                     causal, memory, memory_positions, chunk_threshold,
                     train):
    """Sharded attention where "model" does not divide the KV heads
    (module docstring): q, k and v whole on every rank (`Layout.columns`;
    k and v from `memory` in a cross-attention, else rotated with q);
    the rank's units of the B·H (row, query head) pairs attend, each as
    one batch entry with its KV head, on the route `_attention` takes;
    their outputs gathered whole feed the rank's rows of wo."""
    descr = attn_params(cfg)
    H, Hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_width
    B, S = x.shape[:2]
    index = positions is None
    if index:
        positions = _index_positions(cfg, x)
    x = lay.copy(x)
    src = x if memory is None else memory
    q = _heads(lay.columns(x, params["wq"], descr["wq"]), H, dh)
    k, v = (_heads(lay.columns(src, params[n], descr[n]), Hkv, dh)
            for n in ("wk", "wv"))
    pos = positions if positions.dim() == 2 else positions[..., 0]
    if memory is None:
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)
        k_pos = pos
    else:
        k_pos = (memory_positions if memory_positions is not None
                 else torch.arange(src.shape[1], device=src.device)
                 [None].expand(src.shape[:2]))
    start, stop, counts = lay.units(B * H)
    unit = torch.arange(start, stop, device=x.device)
    row, kv = unit // H, unit % H // (H // Hkv)
    qu = q.reshape(B * H, S, dh)[start:stop, None]
    ku, vu = k[row, kv][:, None], v[row, kv][:, None]
    if stop > start:
        o = _attend(cfg, qu, ku, vu, pos[row], k_pos[row], kind=kind,
                    causal=causal, cross=memory is not None, index=index,
                    chunk_threshold=chunk_threshold, train=train)
    else:
        # no unit here: the empty output still depends on q, k and v, so
        # this rank takes part in their gathers' backward
        o = qu + (ku + vu).sum(2, keepdim=True)
    o = lay.gather(o[:, 0], 0, counts)                      # (B*H, S, dh)
    return lay.leave(lay.rows(_unheads(o.reshape(B, H, S, dh)),
                              params["wo"], descr["wo"]))


def _attend(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, kind, causal, cross,
            index, chunk_threshold, train):
    """The attention of q (B, H, Sq, dh) over k, v (B, Hkv, Sk, dh) at
    positions q_pos (B, Sq) and k_pos (B, Sk), on the route of the module
    docstring's table; `index` says that the positions are 0..S-1, the
    only ones the flash op takes."""
    window = cfg.window if kind == "local" else None
    scale = _scale(cfg)
    softcap = cfg.attn_logit_softcap
    Sk = k.shape[2]
    banded = window is not None and causal and not cross and Sk > window
    # the flash kernel is forward only and masks by index: serving
    # self-attention at 0..S-1
    flash = not train and index and not cross
    if banded and not flash:
        o = banded_local_attention(q, k, v, q_pos, k_pos, window=window,
                                   softcap=softcap, scale=scale,
                                   block=min(1024, window))
    elif flash and (banded or Sk > chunk_threshold):
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window, softcap=softcap,
                            scale=scale)
    elif Sk > chunk_threshold:
        o = chunked_attention(q, k, v, q_pos, k_pos,
                              causal=causal and not cross, window=window,
                              softcap=softcap, scale=scale,
                              chunk=min(1024, Sk))
    else:
        bias = _mask_bias(q_pos, k_pos, causal=causal and not cross,
                          window=window)
        o = full_attention(q, k, v, bias, softcap=softcap, scale=scale)
    return o


# ------------------------------ decode --------------------------------


def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  device) -> dict:
    """Cache for one attention layer on `device`.  Local layers keep only
    a rotating window-sized buffer."""
    L = min(cfg.window, max_len) if (kind == "local" and cfg.window) else max_len
    dt = DTYPES[cfg.dtype]
    shape = (batch, cfg.kv_heads, L, cfg.head_width)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
    }


def _decode_qkv(params, cfg: ModelConfig, x, pos_b, project=None):
    """q (B, H, 1, dh), k and v (B, Hkv, 1, dh) of the token x (B, 1, D)
    at the positions pos_b (B,) int32, rotary applied.  `project(x,
    name)` gives a projection's product (``x @ params[name]`` unless
    given)."""
    H, Hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_width
    if project is None:
        project = lambda a, name: dense(a, params[name])  # noqa: E731
    if cfg.mrope_sections is not None:
        qpos = pos_b[:, None, None].expand(x.shape[0], 1, 3)
    else:
        qpos = pos_b[:, None]
    q = _apply_rope(cfg, _heads(project(x, "wq"), H, dh), qpos)
    k = _apply_rope(cfg, _heads(project(x, "wk"), Hkv, dh), qpos)
    return q, k, _heads(project(x, "wv"), Hkv, dh)


def _decode_attend(params, cfg: ModelConfig, q, k, v, keep):
    """The token's attention over keys k, v (B, Hkv, Sk, dh) where `keep`
    (B, Sk) holds, then the output projection; masked keys take the
    exact `_NEG_INF` bias."""
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(keep, zero, _NEG_INF)[:, None, :]   # (B,1,Sk)
    o = full_attention(q, k, v, bias, softcap=cfg.attn_logit_softcap,
                       scale=_scale(cfg))
    return dense(_unheads(o), params["wo"])


def decode_attention(params, cfg: ModelConfig, x, cache: dict, step: int, *,
                     kind: str = "attn", memory_kv=None, dp=None):
    """x: (B, 1, D) at absolute position `step`.  Writes the token's K, V
    and position into slot ``step % L`` of the cache IN PLACE (the
    reference returns new arrays; the tensors of the returned cache are
    the ones passed in) and attends over the valid slots.

    With `memory_kv`, a precomputed cross-attention's (k, v, k_pos) (k
    and v (B, Hkv, Sm, dh)), the token attends over all of it instead,
    without rotary, and the cache is returned untouched.

    `dp` under a mesh: sharded as `attention`; the cache holds this
    rank's rows and its block of the KV heads, or where "model" does not
    divide them its block of every head's positions (`sharded.cache_spec`,
    as `models.model.init_cache` builds it).  `memory_kv` then holds the
    rank's rows and its Hkv/m KV heads, or where "model" does not divide
    them every KV head, of which the rank attends with its (row, query
    head) units."""
    lay = sharded.layout(None, dp)
    if lay is not None:
        if memory_kv is not None and not lay.heads_divide(cfg):
            return _decode_memory_units(params, cfg, x, memory_kv, lay), cache
        if not lay.heads_divide(cfg):
            return _decode_positions(params, cfg, x, cache, step, kind, lay)
        w = lay.params(params, attn_params(cfg))
        h, new = decode_attention(w, lay.local_cfg(cfg), lay.copy(x), cache,
                                  step, kind=kind, memory_kv=memory_kv)
        return lay.reduce(h), new
    if memory_kv is not None:
        k, v, _ = memory_kv
        q = _heads(dense(x, params["wq"]), cfg.num_heads, cfg.head_width)
        keep = torch.ones((x.shape[0], k.shape[2]), dtype=torch.bool,
                          device=x.device)
        return _decode_attend(params, cfg, q, k, v, keep), cache
    pos_b = torch.full((x.shape[0],), int(step), dtype=torch.int32,
                       device=x.device)
    q, k_new, v_new = _decode_qkv(params, cfg, x, pos_b)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    slot = int(step) % k.shape[2]
    k[:, :, slot] = k_new[:, :, 0]
    v[:, :, slot] = v_new[:, :, 0]
    pos[:, slot] = pos_b
    keep = (pos >= 0) & (pos <= pos_b[:, None])
    if kind == "local" and cfg.window is not None:
        keep &= pos > (pos_b[:, None] - cfg.window)
    return (_decode_attend(params, cfg, q, k, v, keep),
            {"k": k, "v": v, "pos": pos})


def _decode_memory_units(params, cfg: ModelConfig, x, memory_kv, lay):
    """`decode_attention(memory_kv=)` where "model" does not divide the
    KV heads: q whole on every rank, the rank's (row, query head) units
    attend over the whole memory k and v of their KV head, the outputs
    gathered whole feed the rank's rows of wo."""
    descr = attn_params(cfg)
    B = x.shape[0]
    H, Hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_width
    k, v, _ = memory_kv
    q = _heads(lay.columns(lay.copy(x), params["wq"], descr["wq"]), H, dh)
    start, stop, counts = lay.units(B * H)
    unit = torch.arange(start, stop, device=x.device)
    row, kv = unit // H, unit % H // (H // Hkv)
    qu = q.reshape(B * H, 1, dh)[start:stop, None]
    bias = torch.zeros((stop - start, 1, k.shape[2]), dtype=torch.float32,
                       device=x.device)
    o = full_attention(qu, k[row, kv][:, None], v[row, kv][:, None], bias,
                       softcap=cfg.attn_logit_softcap, scale=_scale(cfg))
    o = lay.gather(o[:, 0], 0, counts)                      # (B*H, 1, dh)
    h = lay.rows(_unheads(o.reshape(B, H, 1, dh)), params["wo"], descr["wo"])
    return lay.reduce(h)


def _decode_positions(params, cfg: ModelConfig, x, cache: dict, step: int,
                      kind: str, lay):
    """`decode_attention` where "model" does not divide the KV heads
    (flash-decode): the cache holds this rank's block of the positions
    of every KV head (all of them where "model" does not divide the
    length); q, k and v of the token are whole on every rank, the rank
    holding the step's slot writes k and v there, every rank writes the
    position; each rank's softmax over its positions in f32 is combined
    by a pmax of the maxima and a psum of the sums and weighted values
    over "model"; the rank's rows of wo take the whole output."""
    descr = attn_params(cfg)
    B = x.shape[0]
    H, Hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_width
    pos_b = torch.full((B,), int(step), dtype=torch.int32, device=x.device)
    q, k_new, v_new = _decode_qkv(
        params, cfg, x, pos_b,
        lambda a, name: lay.columns(a, params[name], descr[name]))
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    L, own = pos.shape[1], k.shape[2]
    split = own < L
    off = lay.model_index() * own if split else 0
    slot = int(step) % L
    if off <= slot < off + own:
        k[:, :, slot - off] = k_new[:, :, 0]
        v[:, :, slot - off] = v_new[:, :, 0]
    pos[:, slot] = pos_b
    kp = pos[:, off:off + own]
    keep = (kp >= 0) & (kp <= pos_b[:, None])
    if kind == "local" and cfg.window is not None:
        keep &= kp > (pos_b[:, None] - cfg.window)
    qg = q.reshape(B, Hkv, H // Hkv, 1, dh).float() * _scale(cfg)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    c = cfg.attn_logit_softcap
    if c is not None:
        s = c * torch.tanh(s / c)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    s = s + torch.where(keep, zero, _NEG_INF)[:, None, None, None, :]
    mx = s.amax(dim=-1, keepdim=True)
    if split:
        mx = C.pmax(mx, lay.mesh, "model")
    p = torch.exp(s - mx)
    acc = torch.cat([torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()),
                     p.sum(dim=-1, keepdim=True)], dim=-1)
    if split:
        acc = C.psum(acc, lay.mesh, "model")
    o = (acc[..., :-1] / acc[..., -1:]).reshape(B, H, 1, dh).to(q.dtype)
    h = lay.rows(_unheads(o), params["wo"], descr["wo"])
    return lay.reduce(h), {"k": k, "v": v, "pos": pos}


# --------------------------- paged decode ------------------------------


def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                        device) -> dict:
    """Page-pool KV cache for one attention layer on `device`:
    ``(num_pages + 1, Hkv, page_size, dh)``.  The extra page at index
    `num_pages` is the trash page: it takes the writes of masked slots,
    so one step serves any pattern of live slots."""
    dt = DTYPES[cfg.dtype]
    shape = (num_pages + 1, cfg.kv_heads, page_size, cfg.head_width)
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


def paged_decode_attention(params, cfg: ModelConfig, x, cache: dict,
                           page_map, steps, write_mask, *,
                           kind: str = "attn"):
    """`decode_attention` through a page table.

    x: (B, 1, D); page_map: (B, P) int physical page of each logical
    page (the trash page where none is held); steps: (B,) int each
    slot's absolute position; write_mask: (B,) bool, False sends the
    slot's write to the trash page.

    The token's K and V are written into its page IN PLACE (the
    reference returns new pools; the returned cache holds the pools
    passed in).  Position t of slot b lies at page ``page_map[b, t //
    ps]``, offset ``t % ps``, so the gathered ``(B, Hkv, P*ps, dh)``
    view is the dense cache's layout, and entries past each slot's
    position carry the exact `_NEG_INF` bias: they add exact zeros to
    the softmax, and paged decode equals dense decode bit for bit when
    ``P*ps`` is the dense cache's length.  Several masked slots may
    write the trash page in one step, in an undefined order on the card;
    only the trash page, always masked, is affected.
    """
    B, Hkv, dh = x.shape[0], cfg.kv_heads, cfg.head_width
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    num_pages, ps = k_pages.shape[0] - 1, k_pages.shape[2]
    P = page_map.shape[1]
    pos_b = steps.to(torch.int32)
    q, k_new, v_new = _decode_qkv(params, cfg, x, pos_b)

    # the new token's KV into its page (the trash page when masked)
    page_map = page_map.long()
    logical = torch.clamp(pos_b.long() // ps, 0, P - 1)
    phys = page_map.gather(1, logical[:, None])[:, 0]
    phys = torch.where(write_mask, phys, num_pages)
    off = pos_b.long() % ps
    k_pages[phys, :, off] = k_new[:, :, 0]
    v_pages[phys, :, off] = v_new[:, :, 0]

    # the slot's pages gathered back into its logical sequence
    k = k_pages[page_map].transpose(1, 2).reshape(B, Hkv, P * ps, dh)
    v = v_pages[page_map].transpose(1, 2).reshape(B, Hkv, P * ps, dh)
    k_pos = torch.arange(P * ps, device=x.device, dtype=torch.int32)[None]
    keep = k_pos <= pos_b[:, None]
    if kind == "local" and cfg.window is not None:
        keep &= k_pos > (pos_b[:, None] - cfg.window)
    return (_decode_attend(params, cfg, q, k, v, keep),
            {"k_pages": k_pages, "v_pages": v_pages})
