"""Model sharding over a ("data", "model") mesh, as explicit SPMD on
`torch.distributed`.

Each rank holds its block of every parameter, by the parameter's
sanitized spec (`sanitize_spec`, `shard_params`), and runs the model's
entry points on its block of the batch.  The reference leaves the layout
to GSPMD and only hints it; here it is written out, in Megatron's form
with FSDP:

* a weight's batch-axis ("data") dims are all-gathered at use
  (`gather_param`); in backward its gradient is summed over every
  data-parallel dim ("pod" too, where the weight is replicated) and this
  rank's block kept, which is a reduce-scatter;
* heads and d_ff are split over "model": the column-parallel products
  (wq, wk, wv, wi, wg) take their input through `copy_to_model`
  (forward identity, backward sum over "model"), and the row-parallel
  wo gives a partial sum that `reduce_from_model` completes (forward
  sum, backward identity);
* the vocabulary is split over "model" for the embedding, the
  unembedding and the loss (`vocab_parallel_nll`);
* a parameter that a norm uses whole over its whole input (a norm's
  scale, which P("model") shards) is gathered over "model" too
  (`gather_model`), and its gradient is not summed there: every "model"
  rank computes the same one and keeps its block;
* the hidden state between residual updates is each rank's block
  (B/dp, S, D/m) of its last dim where "model" divides d_model
  (`Layout.for_hidden`), Megatron's sequence-parallel pattern on the
  reference's dim: a norm's input is all-gathered (`Layout.enter`;
  backward, the rank's block of the gradient, unsummed, since every
  "model" rank computes the same norm), a branch's row-parallel partial
  sum is reduce-scattered (`Layout.leave`), and a value already whole
  (a post-norm's output, a lookup of an unsplit vocabulary) is split
  (`Layout.part`).  So a block recomputed in backward saves 1/m of its
  input.  Where "model" does not divide d_model the hidden state is
  (B/dp, S, D), replicated.  The decode steps keep it replicated, as
  the reference constrains nothing there.

Where "model" divides the KV heads, each rank attends with its H/m
query and Hkv/m KV heads (`Layout.local_cfg`).  Where it does not, the
attention is split by units (`Layout.units`): the rank's column blocks
of q, k and v are gathered over "model" into whole heads
(`Layout.gather`), the rank attends over its share of the B_local·H
(row, query head) pairs, each with its KV head, and the outputs are
gathered back whole, of which the rank's row block feeds the
row-parallel wo.  A gather inside the tensor-parallel region sums every
rank's gradient in backward and keeps the rank's block; the KV cache is
then split over its sequence (`cache_spec`), and decode combines each
rank's partial softmax over its positions by a pmax and a psum.  The
rwkv and RG-LRU blocks are split by channel (rwkv's heads where "model"
divides them, else by (row, head) units as attention is); the channel
mix's product, reduce-scattered onto the rank's channels
(`Layout.reduce_scatter`), is the rank's block of the hidden state, or
gathered without a sum where that is replicated.  A cross-attention
splits as the self-attention does, its k and v projected from the
encoder's memory (B/dp, Se, D), which is gathered whole after the
encoder's final norm, replicated over "model", and goes through
`copy_to_model`; the encoder's blocks run under the same layout.  The
mixture of experts keeps the unsharded capacity and ranks over each
chunk of the global token order, and splits its experts over "model"
where "model" divides E, else each expert's d_ff (`models.moe`).

A gradient is summed over a dim only where the ranks along it compute
different contributions: the data-parallel dims, and "model" for the
input of a column-parallel product and for a weight that every "model"
rank uses whole on its own share of the work (`Layout.shared`).  The
reference's `_constrain` and `constrain_act` of the hidden state have
their counterpart in `Layout.for_hidden` and its `enter` / `leave` /
`part`; its `_constrain_heads` and the MoE constraints hint the head
and expert layouts written out here.

`layout(cfg, dp)` gives the sharded layout of a call, or None when no
mesh is in context (`launch.mesh.set_mesh`) or `dp` is None: the model
then runs unsharded, as without a mesh.  It raises NotImplementedError
for a config whose widths "model" does not divide where the layout
needs them to (`check_config`): rwkv or RG-LRU blocks, and attention
whose KV heads and q, k and v projection widths it does not divide.  No
config of the registry is refused at a "model" of 2, 4 or 16.

The collectives are `dist.collectives`' (counted in its account) on the
process groups the mesh was built over; nothing here picks a backend or
catches a failed collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..dist import collectives as C
from ..launch.mesh import mesh_shape
from .config import ModelConfig
from .layers import P_, current_mesh, dense

__all__ = [
    "Layout", "layout", "sanitize_spec", "shard_params", "gather_params",
    "gather_param", "gather_model", "gather_act", "copy_to_model",
    "reduce_from_model", "reduce_from", "vocab_parallel_nll", "local_block",
    "sharded_dims", "gather_blocks", "reduce_scatter", "split_blocks",
    "cache_spec",
]

def _axes(entry) -> tuple:
    """The mesh dims of one spec entry: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sanitize_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """`spec` with each entry whose dims' sizes do not divide the array's
    dim dropped to None (replicated), as the reference's does (whisper's
    51865 vocab on a 16-way "model" dim).  An entry naming a dim the
    mesh lacks is dropped too.  `mesh` is a `DeviceMesh` or a name-to-size
    mapping."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes or i >= len(shape) or any(a not in sizes for a in axes):
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in axes)
        out.append(entry if shape[i] % n == 0 else None)
    return tuple(out)


def sharded_dims(spec: tuple) -> tuple:
    """Every mesh dim a (sanitized) spec shards over."""
    return tuple(a for entry in spec for a in _axes(entry))


def _block(size: int, mesh, axes: tuple) -> tuple[int, int]:
    """(start, length) of this rank's block of a dim of `size` split over
    `axes` (row-major over them)."""
    n = C.axis_size(mesh, axes)
    length = size // n
    return C.axis_index(mesh, axes) * length, length


def local_block(full: torch.Tensor, mesh, spec: tuple,
                keep: Optional[tuple] = None) -> torch.Tensor:
    """This rank's block (a view) of `full` under a sanitized `spec`;
    with `keep`, only the entries over those dims are split."""
    out = full
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if axes and (keep is None or set(axes) <= set(keep)):
            start, length = _block(out.shape[d], mesh, axes)
            out = out.narrow(d, start, length)
    return out


def _gather_dims(x: torch.Tensor, mesh, spec: tuple, dims) -> torch.Tensor:
    """`x` all-gathered along each dim of `spec` whose entry names only
    mesh dims in `dims` (`x` itself where those have one rank)."""
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if (axes and set(axes) <= set(dims)
                and C.axis_size(mesh, axes) > 1):
            x = C.all_gather(x.movedim(d, 0), mesh, axes).movedim(0, d)
    return x


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, spec, dp):
        ctx.mesh, ctx.spec, ctx.dp = mesh, spec, dp
        out = _gather_dims(w, mesh, spec, dp)
        return out.contiguous() if out is not w else w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        if ctx.dp:
            g = C.psum(g, ctx.mesh, ctx.dp)
        return (local_block(g, ctx.mesh, ctx.spec, keep=ctx.dp).contiguous(),
                None, None, None)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        out = _gather_dims(w, mesh, spec, ("model",))
        return out.contiguous() if out is not w else w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return (local_block(g, ctx.mesh, ctx.spec,
                            keep=("model",)).contiguous(), None, None)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.dims), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _psum(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _psum(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """psum with bf16 summed in f32 and rounded once."""
    if x.dtype == torch.bfloat16:
        return C.psum(x.float(), mesh, dims).to(x.dtype)
    return C.psum(x, mesh, dims)


def gather_param(w: torch.Tensor, mesh, spec: tuple, dp) -> torch.Tensor:
    """The parameter block `w` gathered along its dims sharded over the
    data-parallel dims `dp` (FSDP); dims sharded over "model" stay local.
    Backward: the gradient summed over every dp dim, this rank's block
    kept."""
    return _GatherParam.apply(w, mesh, tuple(spec), tuple(dp))


def gather_model(w: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """`w` gathered along its dims sharded over "model", for a value a
    norm uses whole over its whole input.  Backward keeps this rank's
    block of the gradient, unsummed: every "model" rank computes the
    same."""
    return _GatherModel.apply(w, mesh, tuple(spec))


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward identity, backward sum over "model": the input of a
    column-parallel product."""
    return _Copy.apply(x, mesh, ("model",))


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Forward sum over "model", backward identity: the output of a
    row-parallel product."""
    return _Reduce.apply(x, mesh, ("model",))


def reduce_from(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """Forward sum over `dims`, backward identity."""
    return _Reduce.apply(x, mesh, tuple(dims))


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, counts, summed, dims):
        ctx.mesh, ctx.dim, ctx.counts = mesh, dim, counts
        ctx.summed, ctx.dims = summed, dims
        n = max(counts)
        xm = x.movedim(dim, 0)
        if xm.shape[0] < n:
            xm = torch.cat([xm, xm.new_zeros((n - xm.shape[0],)
                                             + xm.shape[1:])])
        parts = C.all_gather(xm, mesh, dims)
        if min(counts) < n:
            parts = torch.cat([parts[r * n:r * n + c]
                               for r, c in enumerate(counts)])
        return parts.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _psum(g, ctx.mesh, ctx.dims)
        j = C.axis_index(ctx.mesh, ctx.dims)
        start = sum(ctx.counts[:j])
        return (g.narrow(ctx.dim, start, ctx.counts[j]).contiguous(), None,
                None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, dims):
        ctx.mesh, ctx.dim, ctx.dims = mesh, dim, dims
        if x.dtype == torch.bfloat16:
            return C.reduce_scatter(x.float(), mesh, dims, dim).to(x.dtype)
        return C.reduce_scatter(x, mesh, dims, dim)

    @staticmethod
    def backward(ctx, g):
        counts = (g.shape[ctx.dim],) * C.axis_size(ctx.mesh, ctx.dims)
        return (_GatherBlocks.apply(g, ctx.mesh, ctx.dim, counts, False,
                                    ctx.dims), None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, dims):
        ctx.mesh, ctx.dim, ctx.dims = mesh, dim, dims
        n = C.axis_size(mesh, dims)
        size = x.shape[dim] // n
        return x.narrow(dim, C.axis_index(mesh, dims) * size,
                        size).contiguous()

    backward = _ReduceScatter.backward


def gather_blocks(x: torch.Tensor, mesh, dim: int, counts=None,
                  summed: bool = True, dims=("model",)) -> torch.Tensor:
    """The blocks of `x` along `dim` of the ranks along the mesh dims
    `dims`, concatenated in rank order; rank r's block holds
    ``counts[r]`` entries (all equal when None).  Backward: the rank's
    block of the gradient, summed over `dims` first when `summed` (the
    gathered value feeds each rank's own share of the work), unsummed
    where every rank computes the same gradient (the hidden state
    gathered for a norm, or a value joining it whole)."""
    dim, dims = dim % x.dim(), tuple(dims)
    if counts is None:
        counts = (x.shape[dim],) * C.axis_size(mesh, dims)
    return _GatherBlocks.apply(x, mesh, dim, tuple(counts), summed, dims)


def reduce_scatter(x: torch.Tensor, mesh, dim: int,
                   dims=("model",)) -> torch.Tensor:
    """The rank's block along `dim` of the sum of `x` over the mesh dims
    `dims` (`collectives.reduce_scatter`; bf16 summed in f32 and rounded
    once); backward: the gradient's blocks gathered, unsummed."""
    return _ReduceScatter.apply(x, mesh, dim % x.dim(), tuple(dims))


def split_blocks(x: torch.Tensor, mesh, dim: int,
                 dims=("model",)) -> torch.Tensor:
    """The rank's block along `dim` of `x`, a value every rank along
    `dims` holds whole and alike; backward: the gradient's blocks
    gathered, unsummed."""
    return _Split.apply(x, mesh, dim % x.dim(), tuple(dims))


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mesh, start):
        Vl = logits.shape[-1]
        m = C.pmax(logits.amax(-1), mesh, "model")
        e = torch.exp(logits - m[..., None])
        sumexp = C.psum(e.sum(-1), mesh, "model")
        local = labels - start
        inside = (local >= 0) & (local < Vl)
        local = local.clamp(0, Vl - 1)
        gold = logits.gather(-1, local[..., None])[..., 0]
        gold = C.psum(torch.where(inside, gold, torch.zeros_like(gold)),
                      mesh, "model")
        ctx.save_for_backward(e, sumexp, local, inside)
        return torch.log(sumexp) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, sumexp, local, inside = ctx.saved_tensors
        grad = e / sumexp[..., None]
        grad.scatter_add_(-1, local[..., None], -inside[..., None].to(e.dtype))
        return grad * g[..., None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, mesh,
                       start: int) -> torch.Tensor:
    """Per-token NLL (f32, labels' shape) from this rank's vocab block of
    the f32 logits (..., V/m), whose first id is `start`: the max by pmax
    (not differentiated), the sum of exp and the target logit by psum
    over "model".  `labels` are global ids (mask them outside).  The
    backward is written out: softmax minus the one-hot, on the block."""
    return _VocabNLL.apply(logits, labels, mesh, int(start))


@torch.no_grad()
def shard_params(full, mesh, specs: dict) -> dict:
    """{name: this rank's block} of the full parameters (a flat dict, or
    a `Transformer`) under their specs, sanitized here against the full
    shapes; each block a copy."""
    if not isinstance(full, dict):
        full = {n: p.detach() for n, p in full.named_parameters()}
    return {k: local_block(v, mesh, sanitize_spec(specs[k], v.shape, mesh))
            .clone() for k, v in full.items()}


def gather_act(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """The whole of a block `x` sharded as `spec` (entries over mesh dims,
    such as (dp, None, "model") for the logits): gathered along every
    entry, in row-major block order.  Not differentiated."""
    with torch.no_grad():
        return _gather_dims(x, mesh, spec, mesh_shape(mesh))


def gather_params(local: dict, mesh, specs: dict) -> dict:
    """{name: the full leaf} of the blocks in `local` under their specs,
    sanitized against the FULL shapes (as `shard_params` sanitizes
    them; `models.model.param_specs(cfg, mesh)` gives them)."""
    return {k: gather_act(v, mesh, specs[k]) for k, v in local.items()}


# ------------------------------ layout --------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """The sharded layout of one call: the mesh, its data-parallel dims
    `dp` and its sizes.  `param` / `whole` gather a weight block at use,
    `copy` / `reduce` bracket a tensor-parallel product.  With
    `hidden_split` the hidden state between residual updates is each
    rank's block (B/dp, S, D/m) (`for_hidden`): `enter` gathers it
    whole before a norm, `leave` turns a branch's partial sum into it
    and `part` a replicated value; without, those keep it replicated
    (`leave` is `reduce`)."""

    mesh: object
    dp: tuple
    sizes: dict
    hidden_split: bool = False

    @property
    def m(self) -> int:
        """The "model" dim's size (1 without one)."""
        return self.sizes.get("model", 1)

    def spec(self, d: P_) -> tuple:
        return sanitize_spec(d.spec, d.shape, self.sizes)

    def split(self, d: P_) -> bool:
        """Whether descriptor `d`'s weight is split over "model"."""
        return "model" in sharded_dims(self.spec(d))

    def fsdp_dims(self, d: P_, dim: int) -> tuple:
        """The data-parallel dims that split dim `dim` of descriptor `d`'s
        weight."""
        return tuple(a for a in _axes(self.spec(d)[dim]) if a in self.dp)

    def local(self, w, d: P_, fsdp: tuple):
        """Weight block `w` with its dp dims other than `fsdp` gathered;
        its gradient summed over those (the rank's work covers the rows
        of every rank along `fsdp` itself)."""
        rest = tuple(a for a in self.dp if a not in fsdp)
        return gather_param(w, self.mesh, self.spec(d), rest)

    def param(self, w, d: P_):
        """Weight block `w` of descriptor `d` with its dp dims gathered."""
        return gather_param(w, self.mesh, self.spec(d), self.dp)

    def params(self, p, descr: dict) -> dict:
        return {k: self.param(p[k], d) for k, d in descr.items()}

    def whole(self, w, d: P_):
        """`w` gathered along every dim, for a value a norm uses whole
        over its whole input."""
        spec = self.spec(d)
        return gather_model(gather_param(w, self.mesh, spec, self.dp),
                            self.mesh, spec)

    def shared(self, w, d: P_):
        """`w` gathered along every dim, for a weight that each "model"
        rank uses whole on its own share of the work: its gradient is
        summed over the dp dims and "model", this rank's block kept."""
        dims = self.dp + (("model",) if "model" in self.sizes else ())
        return gather_param(w, self.mesh, self.spec(d), dims)

    def copy(self, x):
        return copy_to_model(x, self.mesh) if self.m > 1 else x

    def reduce(self, x):
        return reduce_from_model(x, self.mesh) if self.m > 1 else x

    def gather(self, x, dim: int = -1, counts=None, summed: bool = True):
        """`gather_blocks` over "model" (`x` itself when m is 1)."""
        if self.m == 1:
            return x
        return gather_blocks(x, self.mesh, dim, counts, summed)

    def for_hidden(self, cfg: ModelConfig) -> "Layout":
        """This layout with the hidden state between residual updates
        split over "model" where it has more than one rank and they
        divide d_model, as the reference's `_constrain` places
        P(dp, None, "model"); else replicated, as its P(dp) fallback."""
        split = self.m > 1 and cfg.d_model % self.m == 0
        return dataclasses.replace(self, hidden_split=split)

    def enter(self, x):
        """The hidden state `x` whole on every "model" rank, for a norm:
        its blocks gathered.  Backward: the rank's block of the gradient,
        unsummed (every "model" rank computes the same one)."""
        if not self.hidden_split:
            return x
        return gather_blocks(x, self.mesh, -1, summed=False)

    def leave(self, x):
        """A branch's partial sum `x` over "model" completed into the
        hidden state: reduce-scattered to the rank's block, or summed
        whole where the hidden state is replicated."""
        if not self.hidden_split:
            return self.reduce(x)
        return reduce_scatter(x, self.mesh, -1)

    def part(self, x):
        """A value `x` replicated over "model" as the hidden state: the
        rank's block where it is split (backward: the gradient's blocks
        gathered), else `x`."""
        if not self.hidden_split:
            return x
        return split_blocks(x, self.mesh, -1)

    def reduce_scatter(self, x, dim: int = -1):
        """`reduce_scatter` over "model" (`x` itself when m is 1)."""
        return reduce_scatter(x, self.mesh, dim) if self.m > 1 else x

    def block(self, x, dim: int = -1):
        """This rank's block along `dim` of a value replicated over
        "model", split evenly."""
        size = x.shape[dim] // self.m
        return x.narrow(dim, self.model_index() * size, size)

    def model_index(self) -> int:
        return C.axis_index(self.mesh, "model") if "model" in self.sizes else 0

    def units(self, n: int) -> tuple[int, int, tuple]:
        """(start, stop, counts): this rank's share [start, stop) of `n`
        work units split over "model" as evenly as `n` allows, and every
        rank's count (they differ by at most one)."""
        m, j = self.m, self.model_index()
        counts = tuple((r + 1) * n // m - r * n // m for r in range(m))
        return j * n // m, (j + 1) * n // m, counts

    def columns(self, x, w, d: P_):
        """``x @ w`` whole on every "model" rank, `x` being the input of a
        column-parallel product (after `copy`): the rank's column block
        gathered."""
        return self.gather(dense(x, self.param(w, d)))

    def rows(self, x, w, d: P_):
        """The rank's partial sum of ``x @ w`` over its row block of `w`,
        `x` whole on every "model" rank; complete it with `reduce`."""
        return dense(self.block(x), self.param(w, d))

    def heads_divide(self, cfg: ModelConfig) -> bool:
        """Whether "model" divides the KV heads (then the query heads
        too): each rank attends with its own heads."""
        return cfg.kv_heads % self.m == 0

    def local_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The config of this rank's heads where `heads_divide`: H / m
        query and Hkv / m KV heads, `head_dim` pinned to the full
        config's head width (so the width and the attention's scale stay
        the model's)."""
        if not self.heads_divide(cfg):
            raise ValueError(f"{cfg.kv_heads} KV heads do not divide over "
                             f"'model' {self.m}")
        m = self.m
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                                   num_kv_heads=cfg.kv_heads // m,
                                   head_dim=cfg.head_width)


def cache_spec(name: str, shape: tuple, mesh, dp) -> tuple:
    """The reference's name-based rule for one leaf of a layer's decode
    state (`src/repro/launch/specs.py`), sanitized: a KV cache over its
    KV heads, or over its sequence where "model" does not divide them
    (flash-decode); the rwkv state over dp only; the RG-LRU's `h` and
    the token-shift and conv buffers over their channels; the encoder's
    memory over dp."""
    model = mesh_shape(mesh).get("model", 1)
    if name in ("k", "v"):                           # (B, Hkv, L, dh)
        if shape[1] % model == 0:
            return sanitize_spec((dp, "model", None, None), shape, mesh)
        return sanitize_spec((dp, None, "model", None), shape, mesh)
    if name == "memory":                             # (B, Se, D)
        return sanitize_spec((dp, None, None), shape, mesh)
    if name == "pos":                                # (B, L)
        return sanitize_spec((dp, None), shape, mesh)
    if name == "wkv":                                # (B*H, N, N)
        return sanitize_spec((dp, None, None), shape, mesh)
    if name == "h":                                  # (B, D)
        return sanitize_spec((dp, "model"), shape, mesh)
    if name in ("conv", "tm_prev", "cm_prev"):       # (B, w, D)
        return sanitize_spec((dp, None, "model"), shape, mesh)
    return (None,) * len(shape)


def check_config(cfg: ModelConfig, m: int) -> None:
    """Raise NotImplementedError for a config whose widths a "model" dim
    of `m` does not divide where the layout splits them (the module
    docstring)."""
    kinds = set(cfg.layer_kinds())
    qkv = (cfg.num_heads * cfg.head_width, cfg.kv_heads * cfg.head_width)
    widths = {"rwkv": (cfg.d_model, cfg.d_ff), "rglru": (cfg.d_model,),
              # where "model" does not divide the KV heads, the q, k and
              # v projections split by columns
              "attn": () if cfg.kv_heads % m == 0 else qkv}
    widths["local"] = widths["attn"]
    for kind in sorted(kinds & set(widths)):
        if any(w % m for w in widths[kind]):
            raise NotImplementedError(
                f"{cfg.name}: {kind} blocks of widths {widths[kind]} do not "
                f"split over a 'model' dim of {m}")


def layout(cfg: Optional[ModelConfig], dp) -> Optional[Layout]:
    """The sharded layout of a call with data-parallel dims `dp` under the
    mesh in context, or None (no mesh, or `dp` None): the module
    docstring.  With `cfg`, raises for a config this slice does not
    shard.  A `Layout` as `dp` is returned as it is: a block recomputed
    in backward runs where the mesh's context may not be (on the card,
    autograd's own thread), so the model passes its layout down."""
    if isinstance(dp, Layout):
        return dp
    mesh = current_mesh()
    if mesh is None or dp is None:
        return None
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    sizes = mesh_shape(mesh)
    if not hasattr(mesh, "get_group"):
        raise TypeError("a name-to-size mapping describes a mesh; running "
                        "sharded needs a DeviceMesh")
    if set(dp) - set(sizes) or "model" in dp:
        raise ValueError(f"dp={dp} names dims outside the mesh's batch "
                         f"dims; the mesh has {tuple(sizes)}")
    if set(sizes) - set(dp) - {"model"}:
        raise ValueError(f"the mesh's dims {tuple(sizes)} are not dp={dp} "
                         f"and 'model'")
    if cfg is not None:
        check_config(cfg, sizes.get("model", 1))
    return Layout(mesh, dp, sizes)
