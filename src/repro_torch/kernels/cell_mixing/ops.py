"""Public ops for batched cell mixing: mixing-matrix construction
(Metropolis-Hastings weights — symmetric doubly stochastic, the standard
synchronous-gossip mixing choice), identity padding, and the entry point
that sends a CPU tensor to the plain version and a CUDA tensor to the
kernel (``csrc/cell_mixing.cu``) or raises.

`cell_mixing.launches` counts the kernel's launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._build import load_module
from .._guard import refuse_autograd
from .ref import cell_mixing_ref

__all__ = ["mixing_matrix", "pad_mixing", "cell_mixing", "launch_config"]

_SMEM_CAP = 200 * 1024
_DT = 64
_WARP_PATH = (0, False)  # m <= 32: the kernel reads neither d-tile nor flag
_F32 = torch.float32
_LAUNCH = None


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def mixing_matrix(
    neighbors: np.ndarray, degrees: np.ndarray, n_nodes: np.ndarray
) -> np.ndarray:
    """Batched Metropolis-Hastings mixing matrices from padded adjacency.

    W_ij = 1 / (1 + max(d_i, d_j)) for edges, W_ii = 1 - sum_j W_ij,
    identity on padding rows — symmetric, doubly stochastic, with the
    same fixed point (the average) as asynchronous pairwise gossip.
    """
    B, C, D = neighbors.shape
    w = np.zeros((B, C, C), np.float32)
    for b in range(B):
        for i in range(int(n_nodes[b])):
            for s in range(int(degrees[b, i])):
                j = int(neighbors[b, i, s])
                w[b, i, j] = 1.0 / (1.0 + max(degrees[b, i], degrees[b, j]))
        row = w[b].sum(axis=1)
        np.fill_diagonal(w[b], 1.0 - row)
    return w


def pad_mixing(w, x, m_mult: int = 8, d_mult: int = 128):
    """Pad (B, m, m) W with identity and (B, m, d) x with zeros so m is a
    multiple of `m_mult` and d of `d_mult`.  The CUDA kernel needs no
    alignment; this keeps the reference's padded layout available."""
    w = torch.as_tensor(w)
    x = torch.as_tensor(x)
    B, m, d = x.shape
    mp, dp = _round_up(m, m_mult), _round_up(d, d_mult)
    if mp != m:
        w = torch.nn.functional.pad(w, (0, mp - m, 0, mp - m))
        idx = torch.arange(m, mp, device=w.device)
        w[:, idx, idx] = 1.0
        x = torch.nn.functional.pad(x, (0, 0, 0, mp - m))
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
    return w, x, (m, d)


@functools.lru_cache(maxsize=None)
def launch_config(m: int, d: int, smem_cap: int = _SMEM_CAP):
    """(d-tile, W in shared memory?) of the kernel's block path, which
    takes cells of more than 32 slots: a block per (cell, d-tile), W in
    shared memory (rows of m | 1 floats) if it fits beside two tiles of
    the state.  The kernel picks its path and its threads from m."""
    dt = min(d, _DT)
    while dt > 1 and 2 * m * dt * 4 > smem_cap:
        dt //= 2
    w_in_smem = (m * (m | 1) + 2 * m * dt) * 4 <= smem_cap
    return dt, w_in_smem


def _lib():
    """The kernel's launch function, from its extension module (loaded
    on first use): launch(w, x, y, B, m, d, rounds, dt, w_in_smem,
    stream) with pointers and the stream as ints."""
    global _LAUNCH
    if _LAUNCH is None:
        _LAUNCH = load_module("cell_mixing").launch
    return _LAUNCH


def cell_mixing(w, x, *, rounds: int = 1):
    """Apply `rounds` synchronous gossip rounds per cell: W[b]^R @ x[b].

    w: (B, m, m), x: (B, m, d), both float32; on the card both must be
    contiguous and on one device.  The path to the kernel is kept short:
    at the matmul backend's sizes the host's time per call is most of
    the op's: each check is one attribute read, the launch config is
    looked up only for the block path, and the launch goes through an
    extension module's fast-call entry rather than ctypes.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return cell_mixing_ref(w, x, rounds=rounds)
        refuse_autograd("cell_mixing", w, x)
        raise ValueError(f"cell_mixing runs on cpu or cuda, not {x.device}")
    if w.requires_grad or x.requires_grad:  # kept off the short path
        refuse_autograd("cell_mixing", w, x)
    if x.dtype is not _F32 or w.dtype is not _F32 or x.dim() != 3:
        raise ValueError("w and x must be float32 (B, m, m) and (B, m, d)")
    B, m, d = x.shape
    if w.shape != (B, m, m):
        raise ValueError(f"w must be {(B, m, m)}, got {tuple(w.shape)}")
    idx = x.get_device()
    if w.get_device() != idx:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (w.is_contiguous() and x.is_contiguous()):
        raise ValueError("w and x must be contiguous")
    if rounds < 0:
        raise ValueError("rounds must be >= 0")
    dt, w_in_smem = _WARP_PATH if m <= 32 else launch_config(m, d)
    y = torch.empty_like(x)
    args = (w.data_ptr(), x.data_ptr(), y.data_ptr(), B, m, d, int(rounds),
            dt, w_in_smem)
    if idx == torch._C._cuda_getDevice():
        rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = _lib()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        raise RuntimeError(f"cell_mixing kernel launch failed: CUDA error {rc}")
    cell_mixing.launches += 1
    return y


cell_mixing.launches = 0
