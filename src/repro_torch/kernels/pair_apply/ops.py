"""Public op for applying presampled gossip schedules.

A tensor on the CPU goes to the plain version (`ref.pair_apply_ref`); a
tensor on the card goes to the CUDA kernel (``csrc/pair_apply.cu``) or
raises — there is no fallback.  Both produce the same bits.

`pair_apply.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from .._guard import refuse_autograd
from .ref import pair_apply_ref

__all__ = ["pair_apply", "launch_config"]

# shared memory a block may give its cells' state (the staged schedule
# takes under 7 KB beside it, within the H100's 227 KB a block); a block
# takes 32 cells, a lane each, and stages the schedule in tiles of 8
# ticks, two in flight (on an H100 at the n=1e5 finest level, tiles of 8
# timed best, then 16; four tiles in flight were slower)
_SMEM_CAP = 200 * 1024
_CELLS = 32
_TILE = 8


def launch_config(C: int, V: int, T: int, smem_cap: int = _SMEM_CAP):
    """(ticks a staged schedule tile, state in shared memory?) for T
    ticks over C*V-float cells."""
    return max(1, min(_TILE, T)), _CELLS * C * V * 4 <= smem_cap


def _lib():
    lib = load("pair_apply")
    fn = lib.pair_apply_launch
    if fn.argtypes is None:
        p, n = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, n, n, n, n, n, n, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, i, j, upd_i, upd_j):
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, C, V) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    B = x.shape[0]
    for name, a, dtypes in (("i", i, (torch.int32,)), ("j", j, (torch.int32,)),
                            ("upd_i", upd_i, (torch.bool, torch.uint8)),
                            ("upd_j", upd_j, (torch.bool, torch.uint8))):
        if a.dim() != 2 or a.shape[1] != B or a.shape != i.shape:
            raise ValueError(f"{name} must be (T, {B}), got {tuple(a.shape)}")
        if a.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes}, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def pair_apply(x, i, j, upd_i, upd_j, *, smem_cap: int = _SMEM_CAP):
    """Walk a (T, B) presampled exchange schedule over (B, C, V) state.

    See `ref.pair_apply_ref` for the arguments.  On the card, `i`/`j`
    must be int32 and the update bits bool or uint8, all contiguous and
    on x's device.  `smem_cap` bounds the shared memory a block gives
    its cells' state (0 keeps the state in device memory).
    """
    if x.device.type == "cpu":
        return pair_apply_ref(x, i, j, upd_i, upd_j)
    refuse_autograd("pair_apply", x)
    if x.device.type != "cuda":
        raise ValueError(f"pair_apply runs on cpu or cuda, not {x.device}")
    _check(x, i, j, upd_i, upd_j)
    T, B = i.shape
    _, C, V = x.shape
    out = torch.empty_like(x)
    tile, in_smem = launch_config(C, V, T, smem_cap)
    # bool and uint8 bits are both one byte of 0 or 1
    args = (x.data_ptr(), out.data_ptr(), i.data_ptr(), j.data_ptr(),
            upd_i.data_ptr(), upd_j.data_ptr(), T, B, C, V, tile,
            int(in_smem))
    idx = x.get_device()
    if idx == torch._C._cuda_getDevice():
        rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"pair_apply kernel launch failed: CUDA error {rc}")
    pair_apply.launches += 1
    return out


pair_apply.launches = 0
