"""Carry a hierarchy plan built by the reference package into the port.

`plan_from_reference` walks any plan-shaped dataclass by field name
(`dataclasses.fields` and `getattr`) and rebuilds it as the port's
classes, so both engines can run on one identical plan.  It copies the
numpy arrays, recurses into the graph, the partition, the levels and
their routes, and drops the reference's compiled-executor cache, which
has no counterpart here.  It imports nothing of the reference: any
object with the same field names converts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .partition import Partition
from .plan import HierarchyPlan, LevelPlan
from .rgg import Graph
from .routing import BatchedRoutes

__all__ = ["plan_from_reference"]

_DROPPED = ("exec_cache",)


def _copy(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, (list, tuple)):
        return type(value)(_copy(v) for v in value)
    if isinstance(value, dict):
        return {k: _copy(v) for k, v in value.items()}
    return value


def _convert(obj, cls, nested: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if value is None:
            kwargs[f.name] = None
        elif f.name in nested:
            sub = nested[f.name]
            kwargs[f.name] = (tuple(sub(v) for v in value)
                              if f.name == "levels" else sub(value))
        else:
            kwargs[f.name] = _copy(value)
    return cls(**kwargs)


def _routes(obj) -> BatchedRoutes:
    return _convert(obj, BatchedRoutes, {})


def _level(obj) -> LevelPlan:
    return _convert(obj, LevelPlan, {"routes": _routes})


def _graph(obj) -> Graph:
    return _convert(obj, Graph, {})


def _partition(obj) -> Partition:
    return _convert(obj, Partition, {})


def plan_from_reference(obj) -> HierarchyPlan:
    """The port's `HierarchyPlan` with the same contents as `obj`, a
    reference `HierarchyPlan` (its executor cache is dropped)."""
    names = {f.name for f in dataclasses.fields(HierarchyPlan)}
    extra = {f.name for f in dataclasses.fields(obj)} - names
    unknown = extra - set(_DROPPED)
    if unknown:
        raise ValueError(f"unknown plan fields {sorted(unknown)}")
    return _convert(obj, HierarchyPlan, {
        "graph": _graph, "partition": _partition, "levels": _level,
    })
