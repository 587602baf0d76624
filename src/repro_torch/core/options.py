"""Execution options for the plan/execute simulation core.

`ExecOptions` says HOW a plan is executed: the value backend, the
device, the schedule mode, the process mesh, the convergence-check
cadence and the tick budget.  WHAT is simulated stays in the
positional/semantic arguments (`eps`, `seeds`, `weighted`,
`fixed_ticks_scale`) and in `FailureModel` (`core.medium`).

Backends:

* ``"ref"`` — `kernels.pair_apply.pair_apply_ref`, the plain PyTorch
  tick loop;
* ``"cuda"`` — the hand-written `pair_apply` CUDA kernel (bitwise equal
  to ``"ref"``);
* ``"matmul"`` — `core.schedule.compose_schedule` folds each chunk into
  one mixing matrix, applied with the `cell_mixing` CUDA kernel (values
  agree with ``"ref"`` up to f32 rounding; integer accounting is exact).

Schedules: ``"presampled"`` (the schedule/value split) and
``"per_tick"`` (the legacy sequential path, the parity reference; see
`core.gossip`): backend ``"ref"`` there is the reference's ``"lax"``
scan, ``"cuda"`` its ``"pallas"`` branch (one `cell_mixing` launch a
chunk), and ``"matmul"`` is refused.

Meshes (`mesh`, a `torch.distributed` `DeviceMesh`; each rank calls
`execute_plan` with the same arguments and gets the whole result):

* a 1-dim mesh shards the Monte-Carlo trials: each rank runs its
  contiguous block of them (T padded up to a multiple of the mesh size)
  and the outputs are gathered to every rank;
* a 2-dim mesh with dims ``("trials", "nodes")`` shards the trials over
  ``"trials"`` and each level's graph batch over ``"nodes"`` (the draw
  stays global; promotion crosses node blocks through a summed halo
  buffer).  It needs the presampled schedule, and takes neither
  `collect_usage`, a failure scenario nor a cost model, whose
  reductions span the whole batch.

The entry points run on the card unless the caller asks for
``device="cpu"``: without CUDA they raise (`resolve_device`), they never
carry on quietly on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ExecOptions", "resolve_device"]

_ENGINE_BACKENDS = ("ref", "cuda", "matmul")
_SCHEDULES = ("presampled", "per_tick")


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    """Static description of how to execute a plan.

    backend: value pass — "ref", "cuda" or "matmul" (module docstring).
    device: "cuda" (default, optionally "cuda:N") or "cpu".
    schedule: "presampled" (the schedule/value split) or "per_tick"
        (legacy sequential, the parity reference).
    check_every: convergence-oracle cadence (ticks per chunk).
    max_ticks_per_level: per-level tick budget in eps-oracle mode.
    collect_usage: also return the raw per-level flat exchange counters.
    mesh: None, a 1-dim `DeviceMesh` (trial sharding) or a 2-dim one
        with dims ("trials", "nodes") (module docstring).
    """

    backend: str = "cuda"
    device: str = "cuda"
    schedule: str = "presampled"
    check_every: int = 64
    max_ticks_per_level: int = 2_000_000
    collect_usage: bool = False
    mesh: Any = None

    @property
    def node_mesh(self) -> bool:
        """Whether `mesh` is the ("trials", "nodes") mesh."""
        return self.mesh is not None and self.mesh.ndim == 2

    def __post_init__(self):
        if self.backend not in _ENGINE_BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; "
                f"expected one of {_ENGINE_BACKENDS}")
        if self.schedule not in _SCHEDULES:
            raise ValueError(
                f"unknown schedule mode {self.schedule!r}; "
                f"expected one of {_SCHEDULES}")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}")
        if self.backend == "cuda" and torch.device(self.device).type == "cpu":
            raise ValueError(
                "backend='cuda' needs device='cuda'; use backend='ref' or "
                "'matmul' on the CPU")
        if self.mesh is None:
            return
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.mesh.ndim == 2 and names == ("trials", "nodes"):
            if self.schedule != "presampled":
                raise ValueError(
                    "the (trials, nodes) mesh requires schedule='presampled'")
            if self.collect_usage:
                raise ValueError(
                    "collect_usage is not supported on the (trials, nodes) "
                    "mesh (flat usage stays shard-local)")
        elif self.mesh.ndim != 1:
            raise ValueError(
                "execute_plan wants a 1-dim trial mesh or a 2-dim mesh with "
                f"dims ('trials', 'nodes'), got dims {names} of shape "
                f"{tuple(self.mesh.shape)}")


def resolve_device(device) -> torch.device:
    """The torch device of an entry point; raises when CUDA is asked for
    (the default) but unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (with backend='ref' "
            "or 'matmul') to run on the CPU")
    return dev
