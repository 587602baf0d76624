"""Public op for drawing one gossip chunk's exchange schedule.

A tensor on the CPU goes to the plain version (`ref.sample_chunk_ref`);
a tensor on the card goes to the CUDA kernel (``csrc/sample_chunk.cu``)
or raises — there is no fallback.  Both produce the same bits, and add
the same counts into `usage` and `msgs` (and, under a cost model, into
`retx` and `congp`).  Under congestion pricing the kernel counts each
tick's attempts and writes the attempt bits; a few tensor ops then form
the chunk's concurrency pairs, as the plain version does.

`sample_chunk.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.medium import CostModel, FailureCtx
from .._build import load
from .ref import cost_streams, log_q, sample_chunk_ref

__all__ = ["sample_chunk"]

_LAUNCH = None


def _lib():
    """The kernel's C entry point, its signature set on first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = load("sample_chunk").sample_chunk_launch
        p, n, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = ([p] * 13 + [ll, n, n, n, n, n, n, f]
                       + [p, ll, ll, ll, n, f] + [p, n, f, p, p, p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


_WORDS = 0xFFFFFFFF  # a stream's counters are uint32


def _check(t0, T, keys, adj, done, usage, msgs, extra=()):
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
            ("msgs", msgs, (R, B), torch.int32)) + tuple(extra)
    for name, a, shape, dtype in want:
        if a is None:
            raise ValueError(f"{name} is needed")
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != done.device:
            raise ValueError(f"{name} is on {a.device}, done on {done.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sample_chunk(t0: int, T: int, keys, adj, loss_p: Optional[float], done,
                 usage, msgs, failure_ctx: Optional[FailureCtx] = None,
                 cost: Optional[CostModel] = None, hop_cap: int = 1,
                 retx=None, congp=None):
    """Draw ticks ``t0 .. t0+T-1`` of R trials over B graphs, add the
    chunk's exchanges into `usage` and its transmissions into `msgs`, and
    return the value pass's ``(T, R*B)`` i, j, upd_i, upd_j.  With a
    scenario (`failure_ctx`) and a cost model the same launch perturbs
    the schedule and counts retransmissions and concurrency.

    See `ref.sample_chunk_ref` for the arguments.  On the card every
    tensor must be contiguous, of the dtype and shape given there, and
    on one device.
    """
    if done.device.type == "cpu":
        return sample_chunk_ref(t0, T, keys, adj, loss_p, done, usage, msgs,
                                failure_ctx, cost, hop_cap, retx, congp)
    if done.device.type != "cuda":
        raise ValueError(f"sample_chunk runs on cpu or cuda, not "
                         f"{done.device}")
    R, B = done.shape
    C = adj.degrees.shape[1]
    sample_retx, track_cong = cost_streams(cost)
    extra = []
    if failure_ctx is not None:
        extra.append(("failure_ctx.bits", failure_ctx.bits, (B, C),
                      torch.uint8))
    fc = failure_ctx
    strag = fc is not None and fc.straggler_success < 1.0
    words = T * B * (2 * hop_cap if sample_retx else 1)
    if (strag or sample_retx) and words >= _WORDS:
        raise ValueError(f"a tagged draw of {words} words: 2**32 - 1 or "
                         f"more")
    if sample_retx:
        extra.append(("retx", retx, (R, B), torch.int32))
        if log_q(cost.retransmit_p) == 0.0:
            raise ValueError(f"retransmit_p={cost.retransmit_p} rounds q "
                             f"= 1 - p to 1 in f32: no retransmission "
                             f"count to draw")
    if track_cong:
        extra.append(("congp", congp, (R, B), torch.float32))
    if hop_cap < 1:
        raise ValueError(f"hop_cap must be >= 1, got {hop_cap}")
    _check(t0, T, keys, adj, done, usage, msgs, extra)
    dev = done.device
    i = torch.empty((T, R * B), dtype=torch.int32, device=dev)
    j = torch.empty_like(i)
    upd_i = torch.empty((T, R * B), dtype=torch.bool, device=dev)
    upd_j = torch.empty_like(upd_i)
    conc = att = None
    if track_cong:
        conc = torch.zeros((R, T), dtype=torch.int32, device=dev)
        att = torch.empty((T, R * B), dtype=torch.uint8, device=dev)
    # loss_p >= 1 delivers every hop: the outputs of no loss
    lossy = loss_p is not None and loss_p < 1.0

    def ptr(a):
        return None if a is None else a.data_ptr()

    idx = done.get_device()
    args = (keys.data_ptr(), adj.start.data_ptr(), adj.nbr.data_ptr(),
            adj.hops.data_ptr(), adj.degrees.data_ptr(),
            adj.n_nodes.data_ptr(), done.data_ptr(), i.data_ptr(),
            j.data_ptr(), upd_i.data_ptr(), upd_j.data_ptr(),
            usage.data_ptr(), msgs.data_ptr(), int(t0), int(T), R, B, C,
            adj.nbr.shape[0], int(lossy), float(loss_p) if lossy else 1.0,
            ptr(fc.bits) if fc else None, fc.churn_tick if fc else 0,
            fc.reg_t0 if fc else 0, fc.reg_t1 if fc else 0, int(strag),
            fc.straggler_success if fc else 1.0,
            ptr(retx) if sample_retx else None, 2 * hop_cap,
            log_q(cost.retransmit_p) if sample_retx else 0.0, ptr(conc),
            ptr(att))
    if idx == torch._C._cuda_getDevice():
        rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"sample_chunk kernel launch failed: CUDA error "
                           f"{rc}")
    sample_chunk.launches += 1
    if track_cong:
        # the chunk's concurrency pairs, summed in int32, added in f32
        w = torch.sub(conc, 1).clamp_(min=0)
        congp += (att.view(T, R, B) * w.t()[:, :, None]).sum(
            0, dtype=torch.int32).to(torch.float32)
    return i, j, upd_i, upd_j


sample_chunk.launches = 0
