"""Fork-based process-pool helper for plan construction.

Plan building is host-side numpy; the shardable stages (routing chunks,
per-node partition labelling, per-edge cell filtering) are data-parallel
over disjoint index ranges with deterministic chunk-order merges, so the
parallel result is bitwise-identical to the serial one (asserted by the
parity tests).

The pool uses the ``fork`` start method so workers inherit the large
payload arrays (graph CSR, coords) copy-on-write instead of pickling
them per task; the payload is published via a module global immediately
before the pool is created.  On platforms without ``fork`` (or with
``workers <= 1``) everything runs serially in-process — ``workers`` is a
correctness-neutral knob.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, Sequence

__all__ = ["fork_map", "have_fork"]

_PAYLOAD: Any = None


def have_fork() -> bool:
    return "fork" in mp.get_all_start_methods()


def _worker_call(packed):
    fn, task = packed
    return fn(_PAYLOAD, task)


def fork_map(
    fn: Callable[[Any, Any], Any],
    tasks: Sequence[Any],
    *,
    workers: int = 0,
    payload: Any = None,
) -> list:
    """``[fn(payload, t) for t in tasks]``, fanned over a fork pool when
    ``workers > 1``.  `fn` must be a module-level function (pickled by
    reference); `payload` is shared copy-on-write, tasks should be small
    index ranges.  Results come back in task order regardless of which
    worker ran them."""
    tasks = list(tasks)
    if workers <= 1 or len(tasks) <= 1 or not have_fork():
        return [fn(payload, t) for t in tasks]
    global _PAYLOAD
    ctx = mp.get_context("fork")
    _PAYLOAD = payload
    try:
        with ctx.Pool(processes=min(workers, len(tasks))) as pool:
            return pool.map(
                _worker_call, [(fn, t) for t in tasks], chunksize=1
            )
    finally:
        _PAYLOAD = None
