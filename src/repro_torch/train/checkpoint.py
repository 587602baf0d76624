"""Checkpointing: atomic, in the reference's on-disk layout.

* one ``ckpt_{step:010d}/arrays.npz`` per checkpoint with path-flattened
  leaf names (nested dict keys joined by "/"; the parameter names are the
  port's own dotted `named_parameters` names) beside a
  ``manifest.json`` (step, leaf shapes and dtypes, user metadata);
* writes go to ``<dir>/tmp.<step>`` then ``os.replace`` -> crash-safe: a
  partially written checkpoint is never visible;
* bfloat16 leaves are stored widened to float32 (exact) and narrowed
  back on restore;
* keep_n retention; `latest_step` scans the directory so a restarted
  job auto-resumes without coordination state.

The archive is written leaf by leaf (the same zip of ``.npy`` members
``np.savez`` writes), so the host holds one leaf at a time: a
llama3.2-3b AdamW state is 38 GB on disk.  `restore_checkpoint` reads
into the tensors of the state it is given, in place, leaf by leaf,
with a few members read (and their CRCs checked) ahead by threads.

Elastic checkpoints (the state of a model-sharded step, `models.sharded`):
with `shardings` (a tree of specs mirroring the state, as
`launch.specs.state_shardings` gives them, sanitized against the full
shapes) and a mesh (`mesh=`, else the one in context), every rank calls
`save_checkpoint` with its blocks: each leaf is gathered whole, the
mesh's first rank alone writes, publishes and prunes, and the others
wait at a barrier of the default process group.  `restore_checkpoint`
with the NEW mesh's shardings gives each rank its block on that mesh,
whatever mesh wrote the checkpoint.  The files are the unsharded ones.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import current_mesh
from ..models.sharded import gather_act, local_block

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps"]

_SEP = "/"
# members read ahead of the one being restored: each reader checks its
# member's CRC in zlib, which releases the interpreter lock, and at most
# this many members (one leaf each) wait in host memory
_READ_AHEAD = 4


def _flatten(tree, prefix: str = "") -> dict:
    """Leaves of nested dicts by their "/"-joined path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # exact in f32
            t = t.float()
        return t.cpu().numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _mesh_of(mesh):
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("sharded checkpoints need a mesh: pass mesh= or "
                         "call under launch.mesh.set_mesh")
    return mesh


def _whole(state: dict, shardings: dict, mesh):
    """(key, leaf) of `state`, each sharded tensor gathered whole."""
    specs = _flatten(shardings)
    for key, leaf in _flatten(state).items():
        if torch.is_tensor(leaf) and specs.get(key):
            leaf = gather_act(leaf, mesh, specs[key])
        yield key, leaf


def save_checkpoint(directory: str, state: dict, step: int, *,
                    keep_n: int = 3, metadata: Optional[dict] = None,
                    shardings: Optional[dict] = None, mesh=None) -> str:
    """Write `state` as checkpoint `step`; returns its directory.  With
    `shardings`, every rank of the mesh calls it with its blocks (module
    docstring)."""
    final = os.path.join(directory, f"ckpt_{step:010d}")
    if shardings is None:
        _write(directory, _flatten(state).items(), step, keep_n, metadata)
        return final
    mesh = _mesh_of(mesh)
    leaves = _whole(state, shardings, mesh)
    if dist.get_rank() == int(mesh.mesh.reshape(-1)[0]):
        _write(directory, leaves, step, keep_n, metadata)
    else:
        for _ in leaves:  # the gathers, in the writer's order
            pass
    dist.barrier()
    return final


def _write(directory: str, leaves, step: int, keep_n: int,
           metadata: Optional[dict]) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"ckpt_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    shapes = {}
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves:
            a = _to_numpy(leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            shapes[key] = {"shape": list(a.shape), "dtype": str(a.dtype)}
            del a
    manifest = {"step": int(step), "leaves": shapes,
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # re-saving the same step: drop the old one
        shutil.rmtree(final)
    os.replace(tmp, final)     # atomic publish
    _prune(directory, keep_n)


def _prune(directory: str, keep_n: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(directory, f"ckpt_{s:010d}"))


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d{10})", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _unflatten_like(like, arrays, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, arrays, f"{prefix}{k}{_SEP}")
                for k, v in like.items()}
    a = arrays(prefix[:-1])
    if torch.is_tensor(like):
        src = torch.as_tensor(a)
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"{prefix[:-1]}: checkpoint shape "
                             f"{tuple(src.shape)} != {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(src.to(like.dtype))
        return like
    return type(like)(a.item()) if isinstance(like, (bool, int, float)) else a


def _read_member(archive: str, key: str) -> np.ndarray:
    with np.load(archive) as z:  # its own handle: no file shared by threads
        return z[key]


def restore_checkpoint(directory: str, state_like: dict, *,
                       step: Optional[int] = None,
                       shardings: Optional[dict] = None, mesh=None):
    """(state, step): the checkpoint read into the structure of
    `state_like`.  Its tensors receive the stored values in place (each
    keeps its device and dtype); its other leaves (the step counter) are
    replaced in the returned dict.  With `shardings` (the NEW mesh's,
    module docstring), `state_like` holds this rank's blocks on that
    mesh (`mesh=`, else the one in context), and each receives its block
    of the stored leaf."""
    specs = {}
    if shardings is not None:
        mesh = _mesh_of(mesh)
        specs = _flatten(shardings)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"ckpt_{step:010d}")
    archive = os.path.join(path, "arrays.npz")
    with np.load(archive) as z:
        stored = set(z.files)
    keys = list(_flatten(state_like))
    missing = set(keys) - stored
    if missing:
        raise KeyError(f"checkpoint {path} missing leaves: "
                       f"{sorted(missing)[:5]}")
    # members are consumed in `keys` order, the next few read meanwhile
    with ThreadPoolExecutor(max_workers=_READ_AHEAD) as pool:
        pending = collections.deque()
        ahead = iter(keys)

        def arrays(key):
            while len(pending) < _READ_AHEAD:
                nxt = next(ahead, None)
                if nxt is None:
                    break
                pending.append((nxt, pool.submit(_read_member, archive,
                                                 nxt)))
            got, future = pending.popleft()
            assert got == key, (got, key)
            a = future.result()
            if specs.get(key):
                return local_block(torch.as_tensor(a), mesh, specs[key])
            return a

        state = _unflatten_like(state_like, arrays)
    return state, step
