"""Fake launches, for a dry run that traces the model on fake tensors
(`launch.dryrun`).

A kernel op launches through ctypes with its tensors' data pointers,
which a `FakeTensor` does not have.  So an op given a fake tensor
launches nothing: it returns a fake tensor of its output's shape and
dtype and adds one launch, with the operations and bytes the kernel's
function needs (its `work`), to this module's record.  A real tensor
never takes that branch.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["FakeTensor", "fake_launch", "fake_launches", "reset"]

# kernel name -> [launches, operations, bytes]
_RECORD: dict[str, list] = {}


def fake_launch(name: str, work: dict) -> None:
    """Record one fake launch of kernel `name` doing `work`
    ({"flops": ..., "bytes": ...})."""
    row = _RECORD.setdefault(name, [0, 0, 0])
    row[0] += 1
    row[1] += work["flops"]
    row[2] += work["bytes"]


def fake_launches() -> dict:
    """{kernel: {"launches", "flops", "bytes"}} since the last reset."""
    return {k: {"launches": n, "flops": f, "bytes": b}
            for k, (n, f, b) in sorted(_RECORD.items())}


def reset() -> None:
    """Set the record to zero."""
    _RECORD.clear()
