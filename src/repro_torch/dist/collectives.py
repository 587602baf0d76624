"""Collectives over the named dims of a `DeviceMesh`.

The torch form of the `lax` collectives that the reference's
`shard_map` bodies call.  Each rank is one program of the reference's
`shard_map`: it holds its own shard and calls the same function with
the same arguments (SPMD).  A collective over several dims acts on the
ranks that share every other coordinate, in row-major order over the
dims as given, which is the order `lax` collectives use for a tuple of
axis names and the reference's replica order.

  axis_index / axis_size  this rank's row-major index over dims, and
                          the number of ranks there
  ppermute                point to point along (src, dst) index pairs;
                          a rank no pair sends to receives zeros
                          (`ppermutes`: several pair lists, one batch)
  psum / pmax / pmean     all-reduce sums and maxima; `pmean` sums in
                          f32 and rounds the mean to the input's dtype
  bcast_from_zero         every rank adopts the value at index 0
  all_gather              the ranks' tensors concatenated (``tiled``)
                          or stacked along a new leading dim
  reduce_scatter          the rank's block of the sum (a dim split
                          evenly over the ranks, row-major)

A reduction over several dims runs one dim at a time, finest last dim
first; a gather or a reduce-scatter likewise, so its blocks are in
row-major order.  A dim of size 1 is skipped: its collective is the
identity.  The
process group is the caller's: collectives go to the groups the mesh
was built over (gloo, NCCL), and nothing here picks a backend or
catches a failed collective.  Point-to-point transfers address global
ranks in the default group.

gloo moves CUDA tensors in some collectives only (`_GLOO_CUDA`); for
the others this module copies the tensor to the host, runs the
collective there and copies the result back.  The computation stays on
the card.  gloo has no reduce-scatter: there it is an all-reduce (on
the card itself) and the rank's block, so its values are bitwise
`psum`'s.

The account: every call adds one to its kind's count and the bytes
this rank puts in (a reduction's or a broadcast's tensor, a gather's
input, a permutation's sent rows), and every host copy does the same
under ``"host_copy"``.  Each entry also sums the bytes of the call's
result (a gather's whole output, a reduce-scatter's block; for the
others, as many as go in),
which is what the reference's HLO count reads off an op's result shape,
and splits the calls by the group they ran over: its mesh dims and its
global ranks (``"groups"``), so a call across pods can be told from one
inside a pod.  `account()` reads it and `reset_account()` sets it to
zero; it stands in for the reference's HLO collective count
(`launch.trace_analysis` turns it into that count's statistics).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

__all__ = [
    "account",
    "all_gather",
    "axis_index",
    "axis_size",
    "bcast_from_zero",
    "pmax",
    "pmean",
    "ppermute",
    "ppermutes",
    "psum",
    "reduce_scatter",
    "reset_account",
]

Dims = Union[str, int, Sequence[Union[str, int]]]

# collectives that gloo runs on CUDA tensors itself (torch's backend
# table); the rest are staged through the host
_GLOO_CUDA = frozenset({"all_reduce", "broadcast"})

# kind -> (dims, ranks) -> [calls, bytes in, result bytes]
_ACCOUNT: dict[str, dict[tuple, list[int]]] = {}


def reset_account() -> None:
    """Set every count of the account to zero."""
    _ACCOUNT.clear()


def account() -> dict:
    """{kind: {"calls": n, "bytes": b, "result_bytes": r, "groups":
    [{"dims": [...], "ranks": [...], "calls", "bytes", "result_bytes"},
    ...]}} since the last reset; a host copy's group is empty."""
    out = {}
    for kind, groups in sorted(_ACCOUNT.items()):
        rows = [{"dims": list(d), "ranks": list(r), "calls": c, "bytes": b,
                 "result_bytes": rb}
                for (d, r), (c, b, rb) in sorted(groups.items())]
        out[kind] = {k: sum(g[k] for g in rows)
                     for k in ("calls", "bytes", "result_bytes")}
        out[kind]["groups"] = rows
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(kind: str, x, group: tuple = ((), ()),
           result: int = None) -> None:
    """One call of `kind` putting in `x` (a tensor, or its bytes), over
    `group` = (dims, global ranks), with a result of `result` bytes (as
    many as `x` by default)."""
    entry = _ACCOUNT.setdefault(kind, {}).setdefault(group, [0, 0, 0])
    nbytes = x if isinstance(x, int) else _nbytes(x)
    entry[0] += 1
    entry[1] += nbytes
    entry[2] += nbytes if result is None else result


def _dims(dims: Dims) -> tuple:
    return (dims,) if isinstance(dims, (str, int)) else tuple(dims)


def _index(mesh, dim) -> int:
    if isinstance(dim, int):
        return dim
    names = mesh.mesh_dim_names or ()
    if dim not in names:
        raise ValueError(f"mesh has no dim {dim!r}; its dims are {names}")
    return names.index(dim)


def axis_size(mesh, dims: Dims) -> int:
    """The number of ranks along `dims` (their sizes' product)."""
    n = 1
    for d in _dims(dims):
        n *= mesh.size(_index(mesh, d))
    return n


def axis_index(mesh, dims: Dims) -> int:
    """This rank's row-major index over `dims`."""
    idx = 0
    for d in _dims(dims):
        i = _index(mesh, d)
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _group_ranks(mesh, dims: tuple) -> list[int]:
    """Global ranks of this rank's group along `dims`, row-major."""
    from torch.utils._python_dispatch import _disable_current_modes

    axes = [_index(mesh, d) for d in dims]
    coord = mesh.get_coordinate()
    # the mesh's rank table is a real tensor: read it outside any mode
    # that traces (a fake-tensor trace of the caller's program)
    with _disable_current_modes():
        sub = mesh.mesh[tuple(slice(None) if i in axes else c
                              for i, c in enumerate(coord))]
        # `sub` keeps the mesh's dim order; put it in the order of `dims`
        kept = sorted(axes)
        return sub.permute([kept.index(a) for a in axes]).reshape(
            -1).tolist()


def _group(mesh, dims: tuple, ranks) -> tuple:
    """The account's key of a call over `dims` among global `ranks`:
    (dim names, ranks)."""
    return (tuple(d if isinstance(d, str) else mesh.mesh_dim_names[d]
                  for d in dims), tuple(ranks))


def _key(mesh, d, group) -> tuple:
    """The account's key of a call over the one dim `d`'s `group`."""
    return _group(mesh, (d,), dist.get_process_group_ranks(group))


# torch's name for a gather into one tensor (older releases have only
# the second)
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


def _moves(group) -> bool:
    """Whether a collective over `group` moves data: the fake backend (a
    traced dry run, `launch.dryrun`) moves nothing, so there a call is
    counted and its result keeps its shape, and no transfer is made."""
    return dist.get_backend(group) != "fake"


def _staged(x: torch.Tensor, op: str, group) -> bool:
    """Whether `x` must go through the host for collective `op`."""
    return (x.is_cuda and op not in _GLOO_CUDA
            and dist.get_backend(group) == "gloo")


def _to_host(x: torch.Tensor) -> torch.Tensor:
    _count("host_copy", x)
    return x.cpu()


def _to_device(host: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    _count("host_copy", host)
    return out.copy_(host)


def _all_reduce(x: torch.Tensor, dims: tuple, mesh, op, kind: str):
    out = x.clone()
    for d in reversed(dims):
        if mesh.size(_index(mesh, d)) == 1:
            continue
        group = mesh.get_group(_index(mesh, d))
        _count(kind, out, _key(mesh, d, group))
        if not _moves(group):
            continue
        if _staged(out, "all_reduce", group):
            host = _to_host(out)
            dist.all_reduce(host, op=op, group=group)
            _to_device(host, out)
        else:
            dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, mesh, dims: Dims) -> torch.Tensor:
    """The sum of `x` over the ranks along `dims` (a new tensor)."""
    return _all_reduce(x, _dims(dims), mesh, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, mesh, dims: Dims) -> torch.Tensor:
    """The elementwise maximum of `x` over the ranks along `dims`."""
    return _all_reduce(x, _dims(dims), mesh, dist.ReduceOp.MAX, "pmax")


def pmean(x: torch.Tensor, mesh, dims: Dims) -> torch.Tensor:
    """The mean of `x` over the ranks along `dims`: summed in f32 (bf16
    upcast), divided, rounded to x's dtype, as `robust.replica_mean`
    does over a dense replica axis.  The sum is reassociated."""
    acc = psum(x.float(), mesh, dims)
    return (acc / axis_size(mesh, dims)).to(x.dtype)


def bcast_from_zero(x: torch.Tensor, mesh, dims: Dims) -> torch.Tensor:
    """Every rank along `dims` adopts the value of index 0 (a new
    tensor): a broadcast, so the value and the sign of a zero are
    kept."""
    out = x.clone()
    for d in _dims(dims):
        if mesh.size(_index(mesh, d)) == 1:
            continue
        group = mesh.get_group(_index(mesh, d))
        src = dist.get_global_rank(group, 0)
        _count("broadcast", out, _key(mesh, d, group))
        if not _moves(group):
            continue
        if _staged(out, "broadcast", group):
            host = _to_host(out)
            dist.broadcast(host, src=src, group=group)
            _to_device(host, out)
        else:
            dist.broadcast(out, src=src, group=group)
    return out


def all_gather(x: torch.Tensor, mesh, dims: Dims,
               tiled: bool = True) -> torch.Tensor:
    """The tensors of the ranks along `dims` in row-major order,
    concatenated along dim 0 (``tiled``) or stacked on a new dim 0."""
    out = x.contiguous() if tiled else x.unsqueeze(0).contiguous()
    for d in reversed(_dims(dims)):
        if mesh.size(_index(mesh, d)) == 1:
            continue
        group = mesh.get_group(_index(mesh, d))
        n = dist.get_world_size(group)
        _count("all_gather", out, _key(mesh, d, group), n * _nbytes(out))
        # the result is the one buffer the device holds: on every backend
        # the parts land in it (through the host where staged), and on
        # the fake one it is allocated alone
        res = out.new_empty((n * out.shape[0],) + tuple(out.shape[1:]))
        if _moves(group):
            staged = _staged(out, "all_gather", group)
            src = _to_host(out) if staged else out
            buf = torch.empty_like(res, device="cpu") if staged else res
            _gather_into(buf, src, group=group)
            if staged:
                _to_device(buf, res)
        out = res
    return out


def reduce_scatter(x: torch.Tensor, mesh, dims: Dims,
                   dim: int = 0) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `x` over the ranks
    along `dims` (a new tensor): the dim split evenly into as many
    blocks as ranks there, rank i taking block i of the row-major
    order.  Each dim of more than one rank is one call, the finest
    first (as `psum` sums), putting in what is left of `x` and giving
    its block: NCCL's reduce-scatter; gloo's all-reduce (which runs on
    CUDA tensors itself) and the block at the end; nothing moved on the
    fake backend."""
    dims, dim = _dims(dims), dim % x.dim()
    n = axis_size(mesh, dims)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {dims}")
    size = x.shape[dim] // n
    live = [d for d in dims if mesh.size(_index(mesh, d)) > 1]
    if not live:
        return x.clone()
    groups = [mesh.get_group(_index(mesh, d)) for d in live]
    ks = [dist.get_world_size(g) for g in groups]
    nbytes = _nbytes(x)
    for d, group, k in reversed(list(zip(live, groups, ks))):
        _count("reduce_scatter", nbytes, _key(mesh, d, group), nbytes // k)
        nbytes //= k
    # the fake backend allocates what gloo's route does: a copy of x
    # and the block
    if not _moves(groups[0]) or dist.get_backend(groups[0]) == "gloo":
        out = x.clone()
        for group in reversed(groups) if _moves(groups[0]) else ():
            dist.all_reduce(out, group=group)
        return out.narrow(dim, axis_index(mesh, dims) * size,
                          size).contiguous()
    # the dim as (n_1, ..., n_k, size) over the live dims; each call takes
    # the finest remaining one's blocks off the front
    y = x.movedim(dim, 0)
    y = y.reshape(tuple(ks) + (size,) + tuple(y.shape[1:]))
    for j in reversed(range(len(live))):
        src = y.movedim(j, 0).contiguous()
        res = src.new_empty(src.shape[1:])
        dist.reduce_scatter_tensor(res, src, group=groups[j])
        y = res
    return y.movedim(0, dim).contiguous()


def ppermute(x: torch.Tensor, mesh, dims: Dims,
             pairs: Sequence[tuple[int, int]]) -> torch.Tensor:
    """`lax.ppermute`: for each (src, dst) pair of row-major indices
    along `dims`, rank src's `x` goes to rank dst.  A rank that no pair
    names as dst gets zeros."""
    return ppermutes(x, mesh, dims, [pairs])[0]


def ppermutes(x: torch.Tensor, mesh, dims: Dims,
              pair_lists: Sequence[Sequence[tuple[int, int]]]) -> list:
    """`ppermute` of `x` under each pair list, every transfer in one
    batch (list k's messages carry tag k), so independent permutations,
    such as a ring round's two shifts, travel together."""
    dims = _dims(dims)
    ranks = _group_ranks(mesh, dims)
    key = _group(mesh, dims, ranks)
    me = axis_index(mesh, dims)
    x = x.contiguous()
    staged = _staged(x, "send", None)
    send = None
    ops, outs, landed = [], [], []
    for tag, pairs in enumerate(pair_lists):
        out = torch.zeros_like(x)
        for src, dst in pairs:
            if src == me and dst == me:
                out.copy_(x)
            elif src == me:
                _count("ppermute", x, key)
                if send is None:
                    send = _to_host(x) if staged else x
                ops.append(dist.P2POp(dist.isend, send, ranks[dst],
                                      tag=tag))
            elif dst == me:
                recv = torch.empty_like(x, device="cpu") if staged else out
                ops.append(dist.P2POp(dist.irecv, recv, ranks[src],
                                      tag=tag))
                if staged:
                    landed.append((recv, out))
        outs.append(out)
    # on the fake backend each receiver keeps its zeros (`_moves`)
    if ops and _moves(None):
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for recv, out in landed:
        _to_device(recv, out)
    return outs
