"""Content-addressed persistent cache for built `HierarchyPlan`s.

A plan is a pure function of (graph spec, partition config, routing
params, plan seed, builder version): hash those into a key, pickle the
built plan under it, and warm runs skip both graph generation and plan
construction (the plan embeds its graph).

* The spec is canonical JSON over plain scalars (``sort_keys``, ``(",",
  ":")`` separators) hashed with sha256, exactly as the reference hashes
  it, so a spec gives the same hex key in both packages.  Seeded graphs
  hash their (kind, n, c, seed, radius) recipe; externally built graphs
  a sha256 digest of coords and CSR adjacency.
* `PLAN_CACHE_VERSION` is in every key: bump it whenever the builder's
  output changes, and old entries miss.
* `workers` is not part of the key: the parallel build is bitwise the
  serial one.
* Writes are atomic (a temp file, then a rename).
* The port's plan is host numpy only (`core.plan`), so an entry holds no
  device tensor.

The port keeps its own cache: `$REPRO_TORCH_PLAN_CACHE`, else
``~/.cache/repro_torch/plan_cache``.  An entry of the JAX package (whose
classes live in ``repro.core.plan``) is never unpickled: the loader
resolves only numpy's and this package's own classes, and anything
else, or a payload this package did not write, is a miss.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import time
from typing import Any, Optional

import numpy as np

from .plan import HierarchyPlan, build_plan
from .rgg import Graph, random_geometric_graph

__all__ = [
    "PLAN_CACHE_VERSION",
    "default_cache_dir",
    "graph_spec",
    "graph_digest_spec",
    "plan_key",
    "load_plan",
    "store_plan",
    "setup_plan",
]

# bump on any change to plan layout or builder semantics; stale entries
# then miss by construction
PLAN_CACHE_VERSION = 1

# what a payload says it is: an entry of another package never matches
_FORMAT = "repro_torch.plan"


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "plan_cache")


def _digest_arrays(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def graph_spec(n: int, *, c: float = 3.0, seed: int = 0,
               radius: Optional[float] = None) -> dict:
    """Spec for a seeded `random_geometric_graph`: the recipe, not the
    arrays, so a warm setup skips generation.  The builder `method` is
    left out: every builder gives the same Graph."""
    return {
        "kind": "rgg",
        "n": int(n),
        "c": float(c),
        "seed": int(seed),
        "radius": None if radius is None else float(radius),
    }


def graph_digest_spec(g: Graph) -> dict:
    """Spec for an externally built graph: a content digest of coords
    and CSR adjacency."""
    return {
        "kind": "digest",
        "n": g.n,
        "radius": float(g.radius),
        "sha256": _digest_arrays(
            g.coords, g.nbr_start, g.nbr_flat, g.degrees),
    }


def plan_key(graph: dict, *, k: Optional[int] = None, a: float = 2.0 / 3.0,
             cell_max: float = 8.0, seed: int = 0,
             rep_mode: str = "random") -> str:
    """Content hash of everything a build depends on (except `workers`,
    which cannot change the output)."""
    spec = {
        "version": PLAN_CACHE_VERSION,
        "graph": graph,
        "plan": {
            "k": None if k is None else int(k),
            "a": float(a),
            "cell_max": float(cell_max),
            "seed": int(seed),
            "rep_mode": str(rep_mode),
        },
    }
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{key}.plan.pkl")


class _Unpickler(pickle.Unpickler):
    """Resolves numpy's and this package's classes only: a class of any
    other package (the JAX package's plan among them) is refused before
    its module is imported."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy", "repro_torch"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused {module}.{name}")


def load_plan(key: str,
              cache_dir: Optional[str] = None) -> Optional[HierarchyPlan]:
    """The cached plan for `key`, or None on a miss: absent, unreadable,
    not this package's payload, another key, or another version."""
    path = _entry_path(cache_dir or default_cache_dir(), key)
    try:
        with open(path, "rb") as f:
            payload = _Unpickler(f).load()
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
            ImportError, TypeError, ValueError):
        return None
    if (not isinstance(payload, dict) or payload.get("format") != _FORMAT
            or payload.get("key") != key
            or payload.get("version") != PLAN_CACHE_VERSION
            or not isinstance(payload.get("plan"), HierarchyPlan)):
        return None
    return payload["plan"]


def store_plan(key: str, plan: HierarchyPlan,
               cache_dir: Optional[str] = None) -> str:
    """Atomically persist `plan` under `key`; returns the entry path."""
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    path = _entry_path(cache_dir, key)
    payload = {"format": _FORMAT, "key": key, "version": PLAN_CACHE_VERSION,
               "plan": plan}
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=5)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def setup_plan(
    n: Optional[int] = None,
    *,
    g: Optional[Graph] = None,
    c: float = 3.0,
    graph_seed: int = 0,
    radius: Optional[float] = None,
    graph_method: str = "bucket",
    k: Optional[int] = None,
    a: float = 2.0 / 3.0,
    cell_max: float = 8.0,
    seed: int = 0,
    rep_mode: str = "random",
    workers: int = 0,
    cache_dir: Optional[str] = None,
    use_cache: bool = True,
    refresh: bool = False,
) -> tuple[HierarchyPlan, dict]:
    """Cached setup: graph generation and plan build, both skipped on a
    hit (the plan embeds its graph).

    Pass either `n` (with the seeded-RGG recipe) or a prebuilt `g`
    (hashed by content).  Returns ``(plan, info)``; info records
    ``cache`` ("hit", "miss" or "off"), ``key``, ``graph_gen_s``,
    ``plan_build_s``, ``load_s`` or ``store_s``, and ``setup_s``.
    `refresh=True` rebuilds and re-stores even if an entry exists.
    """
    if (n is None) == (g is None):
        raise ValueError("pass exactly one of n= or g=")
    t_all = time.perf_counter()
    gspec = (graph_spec(n, c=c, seed=graph_seed, radius=radius)
             if g is None else graph_digest_spec(g))
    key = plan_key(gspec, k=k, a=a, cell_max=cell_max, seed=seed,
                   rep_mode=rep_mode)
    info: dict[str, Any] = {"key": key, "graph_gen_s": 0.0}
    if use_cache and not refresh:
        t0 = time.perf_counter()
        plan = load_plan(key, cache_dir=cache_dir)
        if plan is not None:
            info.update(
                cache="hit",
                load_s=round(time.perf_counter() - t0, 6),
                plan_build_s=dict(plan.build_seconds or {}),
                setup_s=round(time.perf_counter() - t_all, 6),
            )
            return plan, info
    if g is None:
        t0 = time.perf_counter()
        g = random_geometric_graph(n, c=c, seed=graph_seed, radius=radius,
                                   method=graph_method)
        info["graph_gen_s"] = round(time.perf_counter() - t0, 6)
    plan = build_plan(g, k=k, a=a, cell_max=cell_max, seed=seed,
                      rep_mode=rep_mode, workers=workers)
    info["plan_build_s"] = dict(plan.build_seconds or {})
    if use_cache:
        t0 = time.perf_counter()
        store_plan(key, plan, cache_dir=cache_dir)
        info["store_s"] = round(time.perf_counter() - t0, 6)
        info["cache"] = "miss"
    else:
        info["cache"] = "off"
    info["setup_s"] = round(time.perf_counter() - t_all, 6)
    return plan, info
