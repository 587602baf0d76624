"""Public op for drawing one gossip chunk's exchange schedule.

A tensor on the CPU goes to the plain version (`ref.sample_chunk_ref`);
a tensor on the card goes to the CUDA kernel (``csrc/sample_chunk.cu``,
one template: its main-path instance without loss, scenario or cost
model, its instance for every mode but loss, or the one for every mode)
or raises — there is no fallback.  Both produce the same bits, and add
the same counts into `usage` and `msgs` (and, under a cost model, into
`retx` and `congp`).
Under congestion pricing the kernel counts each tick's attempts and
writes the attempt bits, and a second kernel of the same source,
launched by the same call, adds the chunk's concurrency pairs into
`congp`.  `launch_shape` picks the launch on the host.

`sample_chunk.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...core.medium import CostModel, FailureCtx
from .._build import load
from .ref import cost_streams, log_q, sample_chunk_ref

__all__ = ["sample_chunk", "launch_shape", "LaunchShape"]

_LAUNCH = None


def _lib():
    """The kernel's C entry point, its signature set on first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = load("sample_chunk").sample_chunk_launch
        p, n, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = ([p] * 13 + [ll, n, n, n, n, n, n, f]
                       + [p, ll, ll, ll, n, f] + [p, n, f, p, p, p]
                       + [n, n, n, n, n, p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


_WORDS = 0xFFFFFFFF  # a stream's counters are uint32
# csrc/sample_chunk.cu: kMaxThreads (the main path's instance),
# kFullThreads (the others'), kMaxPairs, kTileSlots, kMaxWindow
_MAX_THREADS, _FULL_THREADS = 1024, 640
_MAX_PAIRS, _TILE, _MAX_WINDOW = 512, 32, 8192


class LaunchShape(NamedTuple):
    """How `sample_chunk` launches its kernel (csrc/sample_chunk.cu)."""
    kernel: int   # 0 the main path, 1 every mode but loss, 2 every mode,
                  # 3 every mode at 64-bit offsets
    G: int        # counter pairs a block (graphs c and c + ceil(B/2))
    lanes: int    # threads a pair, each drawing every lanes-th slot
    runs: int     # blocks a trial
    threads: int  # threads a block
    window: int   # usage counters of each graph run kept on chip


@functools.lru_cache(maxsize=256)
def launch_shape(T: int, R: int, B: int, C: int, nflat: int, sms: int,
                 mode: int) -> LaunchShape:
    """The launch of a chunk of `T` ticks for `R` trials over `B` graphs
    of `C` slots and `nflat` edges in all, on a card of `sms` SMs.
    `mode`: 0 no loss, scenario or cost model; 1 a scenario or a cost
    model without loss; 2 loss.

    A block draws G counter pairs of one trial for every tick, two
    ticks a slot, a tile of 32 slots at a time.  The grid is the fewest
    multiple of `sms` blocks, spread over the trials, that keeps G <= 512
    (at least a block a trial), so every SM draws about as many pairs.
    On the main path thread (lane, p) draws slots lane, lane + lanes, ...
    of pair p: as few turns as the thread cap allows, and as few lanes as
    those turns need, so the lanes' turns differ by one at most.  In the
    other modes the threads take the tile's (slot, pair) items in turn,
    as many each; `lanes` is 1 there.  Its usage window holds twice a
    run's share of the edges; a grid smaller than the card keeps none,
    since its blocks would spend more zeroing and flushing one than they
    save."""
    half = (B + 1) // 2
    k = 1
    while True:
        runs = min(half, -(-k * sms // R))
        G = -(-half // runs)
        if G <= _MAX_PAIRS:
            break
        k += 1
    runs = -(-half // G)
    slots = min(_TILE, (T + 1) // 2)
    if mode == 0:
        turns = -(-slots // (_MAX_THREADS // G))
        lanes = -(-slots // turns)
        threads = G * lanes
    else:
        turns = -(-G * slots // _FULL_THREADS)
        lanes, threads = 1, -(-G * slots // turns)
    threads = max(64, -(-threads // 32) * 32, -(-G // 32) * 32)
    window = 0
    if R * runs >= sms:
        window = min(_MAX_WINDOW, -(-2 * G * -(-nflat // B) // 32) * 32)
    wide = T * R * B > 0x7FFFFFFF
    return LaunchShape(3 if wide else mode, G, lanes, runs, threads, window)


@functools.lru_cache(maxsize=None)
def _sms(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


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
    the schedule and counts retransmissions and concurrency.  On the card
    without loss, scenario or cost model, where the two bits are equal,
    upd_j is the same tensor as upd_i.

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
    conc = att = None
    if track_cong:
        conc = torch.zeros((R, T), dtype=torch.int32, device=dev)
        # a word of attempt bits for each graph and each half of a tile
        # of 32 slots
        tiles = -(-((T + 1) // 2) // _TILE)
        att = torch.empty((2 * tiles, R * B), dtype=torch.int32, device=dev)
    # loss_p >= 1 delivers every hop: the outputs of no loss
    lossy = loss_p is not None and loss_p < 1.0
    idx = done.get_device()
    mode = 2 if lossy else int(fc is not None or sample_retx or track_cong)
    shape = launch_shape(T, R, B, C, adj.nbr.shape[0], _sms(idx), mode)
    # without loss, scenario or cost model both update bits are `active`:
    # the kernel writes one tensor, returned as upd_i and upd_j
    upd_j = upd_i if mode == 0 else torch.empty_like(upd_i)

    def ptr(a):
        return None if a is None else a.data_ptr()

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
            ptr(att), ptr(congp) if track_cong else None, shape.kernel,
            shape.G, shape.lanes, shape.threads, shape.window)
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
