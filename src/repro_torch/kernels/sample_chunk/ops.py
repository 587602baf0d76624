"""Public op for drawing one gossip chunk's exchange schedule.

A tensor on the CPU goes to the plain version (`ref.sample_chunk_ref`);
a tensor on the card goes to the CUDA kernel (``csrc/sample_chunk.cu``)
or raises — there is no fallback.  Both produce the same bits, and add
the same counts into `usage` and `msgs`.

`sample_chunk.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import load
from .ref import sample_chunk_ref

__all__ = ["sample_chunk"]

_LAUNCH = None


def _lib():
    """The kernel's C entry point, its signature set on first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = load("sample_chunk").sample_chunk_launch
        p, n = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [ctypes.c_longlong, n, n, n, n, n, n,
                                  ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _check(t0, T, keys, adj, done, usage, msgs):
    if t0 < 0 or T < 0:
        raise ValueError(f"ticks must be >= 0, got t0={t0}, T={T}")
    if done.dim() != 2 or done.dtype != torch.bool:
        raise ValueError(f"done must be (R, B) bool, got {tuple(done.shape)} "
                         f"{done.dtype}")
    R, B = done.shape
    C = adj.degrees.shape[-1]
    nflat = adj.nbr.shape[0]
    want = (("keys", keys, (R, 2), torch.int64),
            ("start", adj.start, (B, C), torch.int32),
            ("nbr", adj.nbr, (nflat,), torch.int32),
            ("hops", adj.hops, (nflat,), torch.int32),
            ("degrees", adj.degrees, (B, C), torch.int32),
            ("n_nodes", adj.n_nodes, (B,), torch.int32),
            ("done", done, (R, B), torch.bool),
            ("usage", usage, (R * nflat,), torch.int32),
            ("msgs", msgs, (R, B), torch.int32))
    for name, a, shape, dtype in want:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != done.device:
            raise ValueError(f"{name} is on {a.device}, done on {done.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sample_chunk(t0: int, T: int, keys, adj, loss_p: Optional[float], done,
                 usage, msgs):
    """Draw ticks ``t0 .. t0+T-1`` of R trials over B graphs, add the
    chunk's exchanges into `usage` and its transmissions into `msgs`, and
    return the value pass's ``(T, R*B)`` i, j, upd_i, upd_j.

    See `ref.sample_chunk_ref` for the arguments.  On the card every
    tensor must be contiguous, of the dtype and shape given there, and
    on one device.
    """
    if done.device.type == "cpu":
        return sample_chunk_ref(t0, T, keys, adj, loss_p, done, usage, msgs)
    if done.device.type != "cuda":
        raise ValueError(f"sample_chunk runs on cpu or cuda, not "
                         f"{done.device}")
    _check(t0, T, keys, adj, done, usage, msgs)
    R, B = done.shape
    C = adj.degrees.shape[1]
    dev = done.device
    i = torch.empty((T, R * B), dtype=torch.int32, device=dev)
    j = torch.empty_like(i)
    upd_i = torch.empty((T, R * B), dtype=torch.bool, device=dev)
    upd_j = torch.empty_like(upd_i)
    # loss_p >= 1 delivers every hop: the outputs of no loss
    lossy = loss_p is not None and loss_p < 1.0
    idx = done.get_device()
    args = (keys.data_ptr(), adj.start.data_ptr(), adj.nbr.data_ptr(),
            adj.hops.data_ptr(), adj.degrees.data_ptr(),
            adj.n_nodes.data_ptr(), done.data_ptr(), i.data_ptr(),
            j.data_ptr(), upd_i.data_ptr(), upd_j.data_ptr(),
            usage.data_ptr(), msgs.data_ptr(), int(t0), int(T), R, B, C,
            adj.nbr.shape[0], int(lossy), float(loss_p) if lossy else 1.0)
    if idx == torch._C._cuda_getDevice():
        rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"sample_chunk kernel launch failed: CUDA error "
                           f"{rc}")
    sample_chunk.launches += 1
    return i, j, upd_i, upd_j


sample_chunk.launches = 0
