"""The flash-attention op: a CPU tensor goes to the plain version, a
CUDA tensor to the hand-written kernel (``csrc/flash_attention.cu``),
anything else raises.

Unlike the reference op, nothing is padded to block multiples: the
kernel bounds-checks the ragged query and key tails itself.
`flash_attention.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .._build import load
from .ref import attention_ref

__all__ = ["flash_attention"]

_HEAD_SIZES = (64, 128, 256)  # the kernel is compiled for these D
_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    fn = load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, n, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, n, n, n, n, n, n, n, n, f, f, n, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, k, v, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    B, Hq, _, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be {(B, 'Hkv', 'Sk', D)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    if D not in _HEAD_SIZES:
        raise ValueError(f"head size {D} is not one of {_HEAD_SIZES}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype, float32 or "
                         "bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"batch {B} or heads {Hq} beyond the grid's 65535")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D), with the
    reference op's options: causal and window masks by index (query i,
    key j from 0), softcap on the scores, GQA as head h reading KV head
    ``h // (Hq / Hkv)``.  f32 math; returns (B, Hq, Sq, D) in q's dtype.
    """
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError("q, k and v must lie on one device")
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_cuda(q, k, v, window, softcap)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        rc = _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, int(causal), window or 0, scale,
            softcap or 0.0, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
