"""The flash-attention op: a CPU tensor goes to the plain version, a
CUDA tensor to the one hand-written kernel of its dtype, anything else
raises.  bf16 runs on ``csrc/flash_attention_sm90.cu`` (wgmma, TMA), f32
on ``csrc/flash_attention.cu`` (f32 FMAs, which hold the reference
tests' f32 tolerance of 2e-5; single-pass TF32 or bf16 tensor-core
products would not, and a 3xTF32 split has not been tried).

Unlike the reference op, nothing is padded to block multiples: the
kernels handle the ragged query and key tails themselves.
`flash_attention.launches` counts the launches of both kernels,
`flash_attention.kernel_launches` those of each, by source name.

A fake q (a dry run's trace) launches nothing: after the checks the
CUDA route makes, but for the data's alignment, the op returns a fake
output and records a fake launch of the kernel of q's dtype with its
`work` (`kernels._fake`); the counts above do not move.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from .._build import load
from .._fake import FakeTensor, fake_launch
from .._guard import refuse_autograd
from .ref import attention_ref

__all__ = ["flash_attention", "work"]

_HEAD_SIZES = (64, 128, 256)  # the kernels are compiled for these D
# the source of the one CUDA kernel of each dtype
KERNELS = {torch.bfloat16: "flash_attention_sm90",
           torch.float32: "flash_attention"}


def kernel_for(device_type: str, dtype) -> Optional[str]:
    """The kernel that runs q of this device type and dtype: None (the
    plain version) on the CPU, else the CUDA kernel of the dtype."""
    if device_type == "cpu":
        return None
    if device_type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{device_type}")
    if dtype not in KERNELS:
        raise ValueError("q, k and v must share one dtype, float32 or "
                         "bfloat16")
    return KERNELS[dtype]


def work(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int, *,
         causal: bool = True, window: Optional[int] = None,
         itemsize: int = 2) -> dict:
    """What the function needs: {"flops": two products of length D for
    each (query, key) pair the masks keep, "bytes": q, k and v read once
    and o written once}.  At (B, Hq, Hkv, S, D) = (4, 24, 8, 4096, 128)
    causal: 4·B·Hq·D·S(S+1)/2 = 412.4 GFLOP."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    return {"flops": 4 * D * B * Hq * pairs,
            "bytes": itemsize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)}


def _fake(q, k, v, window, causal, softcap):
    """The fake launch of a dry run (module docstring), after the checks
    the real launch makes, those of the data's addresses aside."""
    refuse_autograd("flash_attention", q, k, v)
    _check_args(q, k, v, window, softcap)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    fake_launch(kernel_for("cuda", q.dtype),
                work(B, Hq, Hkv, Sq, Sk, D, causal=causal, window=window,
                     itemsize=q.element_size()))
    return torch.empty_like(q)


def _lib(name: str):
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:
        p, n, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, n, n, n, n, n, n, n, n, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, k, v, window, softcap):
    _check_args(q, k, v, window, softcap)
    # what TMA needs: 16-byte aligned base addresses
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")


def _check_args(q, k, v, window, softcap):
    """The kernels' checks that read no data (a fake tensor passes them
    as the real one would)."""
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
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype, float32 or "
                         "bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    # what TMA needs: 16-byte aligned row strides
    if any(a.stride(2) * a.element_size() % 16 for a in (q, k, v)):
        raise ValueError("the rows of q, k and v must be 16-byte aligned")
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
    ``h // (Hq / Hkv)``.  f32 sums (bf16 products for bf16 inputs);
    returns (B, Hq, Sq, D) in q's dtype.
    """
    if isinstance(q, FakeTensor):
        return _fake(q, k, v, window, causal, softcap)
    if q.device.type != "cpu":
        refuse_autograd("flash_attention", q, k, v)
    name = kernel_for(q.device.type, q.dtype)
    if name is None:
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError("q, k and v must lie on one device")
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    _check_cuda(q, k, v, window, softcap)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        rc = _lib(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, int(causal), window or 0, scale,
            softcap or 0.0, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {rc}")
    flash_attention.launches += 1
    flash_attention.kernel_launches[name] += 1
    return o


flash_attention.launches = 0
flash_attention.kernel_launches = {name: 0 for name in KERNELS.values()}
