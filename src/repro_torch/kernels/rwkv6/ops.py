"""The RWKV-6 wkv op: a CPU tensor goes to the plain version, a CUDA
tensor to the hand-written kernel (``csrc/rwkv6.cu``), anything else
raises.

`rwkv6_wkv.launches` counts the kernel's launches.  A fake r (a dry
run's trace) launches nothing: after the checks the CUDA route makes,
but for the data's alignment, the op returns a fake output and records
a fake launch with its `work` (`kernels._fake`); the count does not
move.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from .._fake import FakeTensor, fake_launch
from .._guard import refuse_autograd
from .ref import rwkv6_ref

__all__ = ["rwkv6_wkv", "work"]

_HEAD_SIZES = (16, 32, 64)  # the kernel is compiled for these N
_IN_DTYPES = (torch.float32, torch.bfloat16)


def work(BH: int, T: int, N: int, *, in_bytes: int = 2,
         w_bytes: int = 4) -> dict:
    """What the function needs: {"flops": (5·N² + 5·N) a step and head
    (Sᵀr; diag(w)S + kᵀv; the bonus v·Σ u k r), "bytes": r, k, v, w and u
    read once and y written once}.  At (160, 4096, 64): 13.63 GFLOP."""
    elems = BH * T * N
    return {"flops": (5 * N * N + 5 * N) * T * BH,
            "bytes": elems * (4 * in_bytes + w_bytes) + BH * N * in_bytes}


def _lib():
    fn = load("rwkv6").rwkv6_launch
    if fn.argtypes is None:
        p, n = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, n, n, n, n, n, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(r, k, v, w, u):
    _check_args(r, k, v, w, u)
    if any(a.data_ptr() % 16 for a in (r, k, v, w, u)):
        raise ValueError("r, k, v, w and u must start 16-byte aligned")


def _check_args(r, k, v, w, u):
    """The kernel's checks that read no data (a fake tensor passes them
    as the real one would)."""
    if r.dim() != 3:
        raise ValueError(f"r must be (BH, T, N), got {tuple(r.shape)}")
    BH, T, N = r.shape
    for name, a in (("k", k), ("v", v), ("w", w)):
        if tuple(a.shape) != (BH, T, N):
            raise ValueError(f"{name} must be {(BH, T, N)}, got "
                             f"{tuple(a.shape)}")
    if tuple(u.shape) != (BH, N):
        raise ValueError(f"u must be {(BH, N)}, got {tuple(u.shape)}")
    if r.dtype not in _IN_DTYPES or w.dtype not in _IN_DTYPES:
        raise ValueError("r and w must be float32 or bfloat16")
    if any(a.dtype != r.dtype for a in (k, v, u)):
        raise ValueError("r, k, v and u must share one dtype")
    if any(a.device != r.device for a in (k, v, w, u)):
        raise ValueError("r, k, v, w and u must lie on one device")
    if not all(a.is_contiguous() for a in (r, k, v, w, u)):
        raise ValueError("r, k, v, w and u must be contiguous")
    if N not in _HEAD_SIZES:
        raise ValueError(f"head size {N} is not one of {_HEAD_SIZES}")


def rwkv6_wkv(r, k, v, w, u):
    """RWKV-6 wkv over (BH, T, N) streams; u is the (BH, N) bonus.

    r, k, v, u share one type (float32 or bfloat16); w may be float32
    beside bfloat16 inputs, as the model passes it.  Returns (BH, T, N)
    in ``r.dtype``.  One pass over T: the reference op's time chunks
    carry the state exactly, so they change nothing here.
    """
    if isinstance(r, FakeTensor):
        refuse_autograd("rwkv6", r, k, v, w, u)
        _check_args(r, k, v, w, u)
        BH, T, N = r.shape
        fake_launch("rwkv6", work(BH, T, N, in_bytes=r.element_size(),
                                  w_bytes=w.element_size()))
        return torch.empty_like(r)
    if r.device.type == "cpu":
        if any(a.device.type != "cpu" for a in (k, v, w, u)):
            raise ValueError("r, k, v, w and u must lie on one device")
        return rwkv6_ref(r, k, v, w, u)
    refuse_autograd("rwkv6", r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv runs on cpu or cuda, not {r.device}")
    _check_cuda(r, k, v, w, u)
    BH, T, N = r.shape
    y = torch.empty_like(r)
    with torch.cuda.device(r.device):
        rc = _lib()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), BH, T, N,
            int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {rc}")
    rwkv6_wkv.launches += 1
    return y


rwkv6_wkv.launches = 0
