"""Collective statistics of a traced step for the dry run's roofline:
the counterpart of the reference's `launch/hlo_analysis.py`.

The reference compiles each cell with XLA and reads its collectives off
the HLO text.  The port has no compiler and no HLO: the dry run
(`launch.dryrun`) runs one rank's program op by op on fake tensors over
a fake process group, and every collective the program calls goes
through `dist.collectives`, whose account records the call's kind, the
bytes of its result and the group it ran over (mesh dims and global
ranks).  This module reads that account:

* `collective_stats(account, pod_of)` gives the reference's
  `CollectiveStats` (result bytes in total, across pods, by kind, and
  the number of calls), a call crossing pods where its group's ranks lie
  in more than one pod of `pod_of`;
* `device_pod_map(mesh, pod_size)` gives `pod_of`: each rank's pod, from
  the mesh's "pod" coordinate where it has one, else ``rank //
  pod_size``;
* `secant_totals` extrapolates per-step totals from 1- and 2-unit depth
  variants, as the reference does (XLA counts a scan's body once).  The
  port's eager trace counts every layer, so the dry run does not need
  it; its tests use it to cross-check the full-depth trace.

No HLO parser is ported.  `DTYPE_BYTES` is keyed by torch dtype.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from .mesh import mesh_shape

__all__ = [
    "COLLECTIVES",
    "CollectiveStats",
    "collective_stats",
    "device_pod_map",
    "secant_totals",
    "DTYPE_BYTES",
]

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.float16: 2, torch.bfloat16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

# the account's kinds of collective (`dist.collectives`), the
# reference's all-reduce (psum, pmax), all-gather, reduce-scatter,
# broadcast and collective-permute; and what it counts that is not one
COLLECTIVES = ("psum", "pmax", "all_gather", "reduce_scatter", "broadcast",
               "ppermute")
_NOT_COLLECTIVES = ("host_copy",)


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int = 0
    cross_pod_bytes: int = 0
    by_kind: dict = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, nbytes: int, cross: bool, calls: int = 1):
        self.total_bytes += nbytes
        if cross:
            self.cross_pod_bytes += nbytes
        self.by_kind[kind] = self.by_kind.get(kind, 0) + nbytes
        self.count += calls

    def asdict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "cross_pod_bytes": self.cross_pod_bytes,
            "by_kind": dict(self.by_kind),
            "count": self.count,
        }

    def __sub__(self, other: "CollectiveStats") -> "CollectiveStats":
        return CollectiveStats(
            total_bytes=self.total_bytes - other.total_bytes,
            cross_pod_bytes=self.cross_pod_bytes - other.cross_pod_bytes,
            by_kind={
                k: self.by_kind.get(k, 0) - other.by_kind.get(k, 0)
                for k in set(self.by_kind) | set(other.by_kind)
            },
            count=self.count - other.count,
        )

    def scaled(self, f: float) -> "CollectiveStats":
        return CollectiveStats(
            total_bytes=int(self.total_bytes * f),
            cross_pod_bytes=int(self.cross_pod_bytes * f),
            by_kind={k: int(v * f) for k, v in self.by_kind.items()},
            count=int(self.count * f),
        )

    def __add__(self, other: "CollectiveStats") -> "CollectiveStats":
        return CollectiveStats(
            total_bytes=self.total_bytes + other.total_bytes,
            cross_pod_bytes=self.cross_pod_bytes + other.cross_pod_bytes,
            by_kind={
                k: self.by_kind.get(k, 0) + other.by_kind.get(k, 0)
                for k in set(self.by_kind) | set(other.by_kind)
            },
            count=self.count + other.count,
        )


def device_pod_map(mesh, pod_size: int) -> list[int]:
    """The pod of each global rank of `mesh` (a `DeviceMesh` or a
    name-to-size mapping whose ranks are numbered row-major): its "pod"
    coordinate where the mesh has that dim, else ``rank // pod_size``."""
    sizes = mesh_shape(mesh)
    world = 1
    for s in sizes.values():
        world *= s
    if "pod" not in sizes:
        return [r // pod_size for r in range(world)]
    names = list(sizes)
    i = names.index("pod")
    inner = 1
    for n in names[i + 1:]:
        inner *= sizes[n]
    if isinstance(mesh, Mapping):
        return [(r // inner) % sizes["pod"] for r in range(world)]
    # a DeviceMesh: each rank's place in its rank table
    table = mesh.mesh.reshape(-1).tolist()
    pods = [0] * world
    for flat, rank in enumerate(table):
        pods[rank] = (flat // inner) % sizes["pod"]
    return pods


def collective_stats(account: dict, pod_of) -> CollectiveStats:
    """`CollectiveStats` of a `dist.collectives.account()`: each call's
    result bytes, by kind, a call crossing pods where its group's ranks
    lie in more than one pod of `pod_of` (`device_pod_map`).  Host copies
    are no collective and are left out; a kind outside `COLLECTIVES`
    raises."""
    stats = CollectiveStats()
    for kind, entry in account.items():
        if kind in _NOT_COLLECTIVES:
            continue
        if kind not in COLLECTIVES:
            raise ValueError(f"the account's kind {kind!r} is none of "
                             f"{COLLECTIVES}")
        for g in entry["groups"]:
            cross = len({pod_of[r] for r in g["ranks"]}) > 1
            stats.add(kind, g["result_bytes"], cross, g["calls"])
    return stats


def secant_totals(cost_1u: dict, cost_2u: dict, repeats: int) -> dict:
    """Extrapolate per-step totals from 1-unit / 2-unit depth variants.

    cost dicts carry scalar-addable entries (flops, bytes, CollectiveStats).
    Returns stem + repeats * unit for every key.
    """
    out = {}
    for k in cost_1u:
        a, b = cost_1u[k], cost_2u[k]
        if isinstance(a, CollectiveStats):
            unit = b - a
            stem = a - unit
            out[k] = stem + unit.scaled(repeats)
        else:
            unit = b - a
            out[k] = (a - unit) + repeats * unit
    return out
