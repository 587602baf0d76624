"""Run one function in several processes that form a process group.

`run_ranks(fn, world, *args, backend=..., timeout=...)` starts `world`
processes with the ``spawn`` method (safe in a parent that has started
CUDA or threads), which meet through a file store in a fresh temporary
directory, not a TCP port.  `fn` and its arguments reach the ranks as
one file of plain `pickle.dumps` bytes in that directory (tensors by
value), so starting a rank does not wait for the one before to read
them.  Rank r initialises the default process group
with the caller's `backend`, calls ``fn(r, world, *args)`` and sends its
result back; `run_ranks` returns the results in rank order.  `fn` and
its arguments are pickled, so `fn` is a module-level function.  A
result travels as the bytes of a plain `pickle.dumps` (tensors by
value): a queue's own pickler would share a tensor through a file
descriptor that dies with the rank.

A rank that raises brings the call down with its traceback, a rank that
dies without a result (a native abort) brings it down with its exit
code, and a group that has not finished within `timeout` seconds is
killed and raises `TimeoutError`.  Every process is stopped before
`run_ranks` returns or raises.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

__all__ = ["run_ranks"]


def _rank_main(payload, rank, world, backend, store, timeout, threads,
               results):
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, pickle.dumps(out)))


def run_ranks(fn: Callable, world: int, *args, backend: str,
              timeout: float, threads: Optional[int] = None) -> list:
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    process of one `backend` process group (module docstring).

    timeout: seconds for the whole group, and each collective's timeout
        inside it.
    threads: `torch.set_num_threads` in each rank (and its
        ``OMP_NUM_THREADS`` at start), when given.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs: list = []
    out: dict = {}

    def take(rank, ok, value):
        if not ok:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
        out[rank] = pickle.loads(value)

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        payload = os.path.join(tmp, "payload")
        with open(payload, "wb") as f:
            f.write(pickle.dumps((fn, args)))
        env = os.environ.get("OMP_NUM_THREADS")
        if threads is not None:
            os.environ["OMP_NUM_THREADS"] = str(threads)
        try:
            for r in range(world):
                procs.append(ctx.Process(
                    target=_rank_main,
                    args=(payload, r, world, backend, store, timeout,
                          threads, results), daemon=True))
                procs[-1].start()
            deadline = time.monotonic() + timeout
            while len(out) < world:
                try:
                    take(*results.get(timeout=0.2))
                    continue
                except queue.Empty:
                    pass
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    # a failed rank's traceback may still be in the pipe
                    try:
                        take(*results.get(timeout=2.0))
                        continue
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} died with exit code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within {timeout} s; "
                        f"ranks {sorted(set(range(world)) - set(out))} had "
                        f"not reported")
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            if threads is not None:
                _restore("OMP_NUM_THREADS", env)
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
            results.close()
    return [out[r] for r in range(world)]


def _restore(name: str, value: Optional[str]) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
