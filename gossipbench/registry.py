"""Where the harness finds a cell, its configuration, its traffic mix
and the readers of its per-layer metrics: each is a file of its own,
named after it, under this package.  Adding one adds a file; no file
that is there changes.

* ``cells/<cell>.json``: ``config``, ``traffic``, ``chips``, how many
  calls and trials a call the correctness check samples (``check``),
  how many calls a traced run traces (``trace_calls``) and the
  ``limits`` of the numbers the check compares;
* ``configs/<config>.json``: the deployment as it is run;
* ``traffic/<mix>.json``: trials a call, the scenarios the calls cycle
  through and the cost model;
* ``metrics/<metric>.py``: a `read(ctx)` that returns the metric's value
  or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = HERE) -> dict:
    return _json(root, "cells", name)


def config(name: str, root: Path = HERE) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = HERE) -> dict:
    return _json(root, "traffic", name)


def spec(root: Path = HERE) -> dict:
    """BENCHMARK.json beside this package."""
    with open(root.parent / "BENCHMARK.json") as f:
        return json.load(f)


def metric_names(cell_name: str, kind: str, root: Path = HERE) -> list:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer") as
    BENCHMARK.json lists them: those whose ``workloads`` name the cell,
    or that have none."""
    return [m["name"] for m in spec(root)[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def metric_units(root: Path = HERE) -> dict:
    s = spec(root)
    return {m["name"]: m["unit"] for m in s["end_to_end"] + s["per_layer"]}


def reader(name: str, root: Path = HERE):
    """The `read` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec_ = importlib.util.spec_from_file_location(
        f"gossipbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read
