"""Multi-pod dry run: the counterpart of the reference's
`launch/dryrun.py`.

For every (architecture x input shape x mesh) cell it predicts what one
device holds and does in the production step, without a card and
without the other ranks.  The reference compiles each cell with XLA on
forced host devices and reads memory, cost and collectives off the
compiled module.  The port has no compiler: it runs rank 0's program
for real, op by op, on fake tensors (`FakeTensorMode`) over a fake
process group of the mesh's world size, which builds the production
`DeviceMesh` in one process and whose collectives move nothing:

  1. `build_cell` gives the cell's step and its arguments' shapes and
     specs; the rank's blocks of the arguments are made as fake tensors
     of the local shapes (`local_shape`);
  2. the step runs under `set_mesh`, `FlopCounterMode` (matmul-class
     operations), `MemTracker` (the peak of live tensors) and a
     dispatch mode that sums each operation's input and output bytes;
     the hand-written kernels take a fake launch and add their own work
     (`kernels._fake`), and `dist.collectives`' account records every
     collective (`launch.trace_analysis`);
  3. a JSON record goes to `build/dryrun_torch/` with the memory, the
     fake launches and the roofline terms at the H100's rates.

Eager execution counts every layer, so no depth extrapolation is
needed (the reference's `secant_totals` stays in `trace_analysis` as a
cross-check).  The trace runs in a process of its own (spawned once,
reused for later cells), so the caller's default process group and
device are never touched.  A torch built without CUDA cannot run
autograd on fake CUDA tensors, so there `run_cell` traces on "cpu":
the program is the same, since the model branches on the device only
in the kernel ops, whose fake launch does not look at it.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import time
import traceback

import torch

from ..configs.registry import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from .mesh import mesh_shape
from .trace_analysis import DTYPE_BYTES, collective_stats, device_pod_map

__all__ = ["HW", "DEVICE_BYTES", "active_params", "argument_bytes",
           "close", "local_shape", "main", "model_flops", "roofline_terms",
           "run_cell", "trace_cell"]

# the datasheet's figures for the H100 SXM5 80GB HBM3
HW = {
    "peak_flops_per_chip": 989e12,   # bf16 dense tensor-core FLOP/s
    "hbm_bw_per_chip": 3.35e12,      # HBM3 B/s
    "ici_bw_per_link": 450e9,        # NVLink 4, B/s a direction a GPU
}
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 at a 700 W limit (chip_smoke.py's D1 checks it against the card)
DEVICE_BYTES = 85_017_493_504
ARTIFACT_DIR = os.path.join("build", "dryrun_torch")
POD_SIZE = 256
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


# ------------------------- analytic model flops ------------------------


def active_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts; active replaces each MoE
    layer's E experts by the K routed ones."""
    from ..models import Transformer

    total = Transformer(cfg).num_params
    if not cfg.num_experts:
        return total, total
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k in ("attn", "local"))
    per_expert = 3 * cfg.d_model * cfg.d_ff
    moe_total = n_moe_layers * cfg.num_experts * per_expert
    moe_active = n_moe_layers * cfg.experts_per_token * per_expert
    return total, total - moe_total + moe_active


def model_flops(cfg, shape_name: str) -> float:
    S, B, mode = SHAPES[shape_name]
    _, n_active = active_params(cfg)
    tokens = B * S if mode in ("train", "prefill") else B
    if mode == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


# ------------------------------- the trace -----------------------------

_POOL = None


def close() -> None:
    """Stop the trace's process, if one was started."""
    global _POOL
    if _POOL is not None:
        _POOL.shutdown(wait=True, cancel_futures=True)
        _POOL = None


atexit.register(close)


def _pool():
    global _POOL
    if _POOL is None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        _POOL = ProcessPoolExecutor(max_workers=1,
                                    mp_context=mp.get_context("spawn"))
    return _POOL


def trace_cell(cfg, shape_name, mesh_shape, rank: int = 0,
               device: str = "cuda", *, with_bytes: bool = True) -> dict:
    """Trace rank `rank`'s step of `cfg` at `shape_name` (a `SHAPES`
    name or an (S, B, mode) tuple) on a mesh of `mesh_shape` ({dim name:
    size}), in a process of its own over a fake process group of the
    mesh's world size (module docstring).  `with_bytes` runs the
    byte-counting mode.

    Returns {"flops", "bytes" (None without `with_bytes`), "account"
    (`dist.collectives.account()`), "kernels" (the fake launches),
    "memory": {"argument_bytes", "output_bytes", "temp_bytes",
    "peak_bytes"}, "mode", "num_params", "seconds"}; flops and bytes are
    this device's, the fake launches' work included."""
    from concurrent.futures.process import BrokenProcessPool

    sizes = {str(k): int(v) for k, v in dict(mesh_shape).items()}
    try:
        return _pool().submit(_traced, cfg, shape_name, sizes, rank, device,
                              with_bytes).result()
    except BrokenProcessPool:
        close()     # a new process for the next trace
        raise


# the trace process's fake group and meshes
_MESHES: dict = {}


def _fake_group(world: int, rank: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) == (world, rank):
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _mesh(sizes: dict, device: str):
    from torch.distributed.device_mesh import init_device_mesh

    key = (tuple(sizes.items()), device)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device, tuple(sizes.values()),
                                        mesh_dim_names=tuple(sizes))
    return _MESHES[key]


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """A rank's block shape of an array of `shape` under a sanitized
    `spec` on `mesh` (a `DeviceMesh` or {dim name: size}): each dim
    divided by the sizes of the mesh dims its entry names."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[axis]
    return tuple(out)


def _local_args(args, specs, mesh, make):
    """`args` (meta tensors in nested dicts, lists and tuples; other
    leaves kept as they are) with each tensor replaced by
    ``make(local shape, dtype)`` under the sanitized `specs` that mirror
    them."""
    if isinstance(args, dict):
        return {k: _local_args(v, specs[k], mesh, make)
                for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(_local_args(a, s, mesh, make)
                          for a, s in zip(args, specs))
    if torch.is_tensor(args):
        return make(local_shape(args.shape, specs, mesh), args.dtype)
    return args


def argument_bytes(cell, mesh) -> int:
    """The bytes of a rank's blocks of `cell`'s arguments on `mesh`
    (host integers, such as a step, hold none)."""
    blocks = _local_args(cell.args_abs, cell.in_shardings, mesh,
                         lambda shape, dt: torch.empty(shape, dtype=dt,
                                                       device="meta"))
    return _nbytes(_tensors(blocks))


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * DTYPE_BYTES[t.dtype] for t in tensors)


def _byte_mode():
    """A dispatch mode that sums the bytes of each ATen operation's
    tensor inputs and outputs (views and aliases move nothing and are
    left out, and so are metadata queries and collectives, which
    `dist.collectives` counts)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "aten" and not func.is_view:
                self.total += sum(t.numel() * t.element_size() for t in
                                  _tensors((args, kwargs, out)))
            return out

    return Bytes()


def _traced(*args):
    """`_trace` in the trace process; a failure comes back as a
    RuntimeError holding its traceback (an exception may hold what does
    not pickle)."""
    try:
        return _trace(*args)
    except Exception:
        raise RuntimeError(traceback.format_exc()) from None


def _trace(cfg, shape_name, sizes: dict, rank: int, device: str,
           with_bytes: bool) -> dict:
    """`trace_cell` in the trace process."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from ..dist import collectives as C
    from ..kernels import _fake
    from .mesh import set_mesh
    from .specs import build_cell

    t0 = time.perf_counter()
    world = 1
    for s in sizes.values():
        world *= s
    _fake_group(world, rank)
    mesh = _mesh(sizes, device)
    cell = build_cell(cfg, shape_name, mesh, device=device)
    C.reset_account()
    _fake.reset()
    flops = FlopCounterMode(display=False)
    counter = _byte_mode() if with_bytes else contextlib.nullcontext()
    # the steps and a cache's clock are host integers and stay real
    with FakeTensorMode(allow_non_fake_inputs=True):
        mem = MemTracker()
        with mem:
            args = _local_args(cell.args_abs, cell.in_shardings, mesh,
                               lambda shape, dt: torch.empty(
                                   shape, dtype=dt, device=device))
            arg_bytes = _nbytes(_tensors(args))
            held = sum(v["Total"] for v in
                       mem.get_tracker_snapshot("current").values())
            with set_mesh(mesh), flops, counter:
                out = cell.fn(*args)
            out_bytes = _nbytes(_tensors(out))
            del out, args
        peak = sum(v["Total"] for v in
                   mem.get_tracker_snapshot("peak").values())
    kernels = _fake.fake_launches()
    temp = peak - held
    return {
        "flops": flops.get_total_flops() + sum(k["flops"]
                                               for k in kernels.values()),
        "bytes": (counter.total + sum(k["bytes"] for k in kernels.values())
                  if with_bytes else None),
        "account": C.account(),
        "kernels": kernels,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": temp, "peak_bytes": arg_bytes + temp},
        "mode": cell.mode,
        "num_params": cell.meta["num_params"],
        "seconds": time.perf_counter() - t0,
    }


# ------------------------------- roofline ------------------------------


def roofline_terms(totals: dict, chips: int, hw: dict = HW) -> dict:
    """totals are PER-DEVICE costs (one rank's trace); x chips = fleet
    totals, then the reference's formulas at `hw`'s rates."""
    # clamp tiny negative secant wiggles (variant-dependent stem patterns)
    flops_global = max(totals["flops"], 0.0) * chips
    bytes_global = max(totals["bytes"], 0.0) * chips
    coll = totals["collectives"]
    coll.total_bytes = max(coll.total_bytes, 0)
    coll.cross_pod_bytes = max(coll.cross_pod_bytes, 0)
    compute_s = flops_global / (chips * hw["peak_flops_per_chip"])
    memory_s = bytes_global / (chips * hw["hbm_bw_per_chip"])
    collective_s = coll.total_bytes / (chips * hw["ici_bw_per_link"])
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "hlo_flops_global": flops_global,
        "hlo_bytes_global": bytes_global,
        "collective_bytes": coll.total_bytes,
        "cross_pod_bytes": coll.cross_pod_bytes,
        "collectives_by_kind": coll.by_kind,
    }


# -------------------------------- cells --------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = ARTIFACT_DIR, with_roofline: bool = True) -> dict:
    """The cell's record (module docstring), also written to `out_dir`.
    Its fake tensors are CUDA tensors where this torch has CUDA, else CPU
    ones (module docstring)."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_name}.json".replace("/", "_")
    )
    cfg = get_config(arch)
    runnable, reason = cell_is_runnable(cfg, shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "multi_pod": multi_pod, "status": "skip", "reason": reason,
    }
    if not runnable:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    try:
        sizes = MESHES[mesh_name]
        chips = 1
        for s in sizes.values():
            chips *= s
        tr = trace_cell(cfg, shape_name, sizes, device=device,
                        with_bytes=with_roofline)
        mem = dict(tr["memory"])
        mem["fits"] = bool(mem["peak_bytes"] < DEVICE_BYTES)
        coll = collective_stats(tr["account"],
                                device_pod_map(sizes, POD_SIZE))
        rec.update(
            status="ok",
            trace_seconds=tr["seconds"],
            device=device,
            chips=chips,
            mode=tr["mode"],
            num_params=tr["num_params"],
            memory=mem,
            kernels=tr["kernels"],
            collectives=coll.asdict(),
        )
        if cfg.num_experts:
            # the sharded MoE's expert buffers, whose rows depend on the
            # routing, are traced at the capacity (`models.moe`)
            rec["moe_rows"] = "capacity"
        if with_roofline:
            terms = roofline_terms({"flops": tr["flops"],
                                    "bytes": tr["bytes"],
                                    "collectives": coll}, chips)
            mf = model_flops(cfg, shape_name)
            terms["model_flops"] = mf
            terms["model_flops_ratio"] = (
                mf / terms["hlo_flops_global"] if terms["hlo_flops_global"]
                else 0.0)
            rec["roofline"] = terms
    except Exception as e:  # record the failure: dry-run bugs are bugs
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    cells = []
    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))
    t0 = time.perf_counter()
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, out_dir=args.out,
                       with_roofline=not args.no_roofline)
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (
                f" mem={rec['memory']['peak_bytes'] / 2**30:.1f}GiB"
                f" fits={rec['memory']['fits']}"
            )
            if "roofline" in rec:
                r = rec["roofline"]
                extra += (
                    f" dom={r['dominant']}"
                    f" c={r['compute_s'] * 1e3:.1f}ms"
                    f" m={r['memory_s'] * 1e3:.1f}ms"
                    f" x={r['collective_s'] * 1e3:.1f}ms"
                )
            extra += f" trace={rec['trace_seconds']:.1f}s"
        elif status == "error":
            extra = " " + rec["error"][:120]
        elif status == "skip":
            extra = " " + rec["reason"]
        print(f"[{status:5s}] {arch} {shape} "
              f"{'multi' if mp else 'single'}{extra}", flush=True)
    print(f"{len(cells)} cells in {time.perf_counter() - t0:.1f} s",
          flush=True)
    close()


if __name__ == "__main__":
    main()
