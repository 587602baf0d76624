"""Run one cell of the benchmark once and print its result line.

    python3 -m gossipbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card.  A run:

1. loads the cell, its configuration and its traffic mix (`registry`);
2. sets up: builds the port's two gossip kernels where they are not
   built yet (``build/repro_torch_kernels/``), loads the plan through
   `setup_plan` and its cache (``gossipbench/.cache/plans/``), draws
   each trial's initial values on the card and the trial seeds from
   ``--seed``, and warms up with one untimed call of each scenario the
   traffic cycles through;
3. with ``--trace 0``, runs a closed loop of calls for ``--seconds``: one
   researcher's sweep sends its next batch of trials when the last batch
   is back on the host, each call the next scenario in turn; with
   ``--trace 1``, traces the traffic's number of calls under
   `torch.profiler` instead;
4. checks a sample of the calls, drawn from the seed, against the
   reference (`check`, `reference`), once the program's state is freed;
5. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
   per-layer ones), ``device``, ``breakdown`` (traced runs), ``setup``
   (whether this run built the kernels or missed the plan cache, so a
   cold set-up is told from a slow one) and, last, ``checks``: each
   number compared with its limit, which also end the standard error.

Without a card, or with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
from __future__ import annotations

import time

_START = time.perf_counter()  # set-up runs from here to the first call

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
KERNEL_BUILD = CHECKOUT / "build" / "repro_torch_kernels"
# top-level module names that may not be loaded: JAX, and the JAX
# package and its benchmark drivers
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def log(msg: str) -> None:
    print(f"[gossipbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _import_program():
    """The port, from the checkout's ``src/``, with its kernels built in
    the checkout."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(KERNEL_BUILD)
    src = str(CHECKOUT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core as P

    return P


@dataclasses.dataclass
class Call:
    index: int
    scenario: int
    seeds: list
    seconds: float


class Sampler:
    """Per scenario, a reservoir of `calls` calls drawn from the seed, and
    in each kept call `trials` trials: the batch's first and last rows
    and the rest drawn from the seed (every row where `trials` >= R);
    keeps those trials' outputs."""

    def __init__(self, seed: int, scenarios: int, calls: int, trials: int,
                 R: int):
        import numpy as np

        self.rng = np.random.default_rng([seed, 7])
        self.calls, self.R = calls, R
        self.trials = min(trials, R)
        self.seen = [0] * scenarios
        self.kept = [[] for _ in range(scenarios)]

    def rows(self):
        ends = sorted({0, self.R - 1})[:self.trials]
        rest = self.rng.choice(range(1, self.R - 1), self.trials - len(ends),
                               replace=False) if self.trials > 2 else []
        return sorted([*ends, *(int(r) for r in rest)])

    def offer(self, call: Call, out: dict):
        s = call.scenario
        m = self.seen[s]
        self.seen[s] += 1
        if m < self.calls:
            slot = m
        else:
            slot = int(self.rng.integers(m + 1))
            if slot >= self.calls:
                return
        rows = self.rows()
        keep = {k: v[rows] for k, v in out.items()}
        entry = (call, rows, keep)
        if slot < len(self.kept[s]):
            self.kept[s][slot] = entry
        else:
            self.kept[s].append(entry)


def _outputs(res) -> dict:
    """The outputs a call returns to the researcher, as host arrays."""
    out = dict(x_final=res.x_final, messages=res.messages,
               node_sends=res.node_sends, level_messages=res.level_messages)
    if res.cost is not None:
        out.update(retransmissions=res.cost.retransmissions,
                   congestion=res.cost.congestion)
    return out


def level_shapes(plan, cfg: dict):
    """The plan's levels as the work formulas take them."""
    from .reference.execute import fi_ticks
    from .work.gossip import LevelShape

    out = []
    for lp in plan.levels:
        fixed = fi_ticks(int(lp.n_nodes.max()), cfg["eps"],
                         cfg["fixed_ticks_scale"], lp.kind == "overlay")
        chk = max(1, min(64, fixed))
        out.append(LevelShape(
            kind=lp.kind, B=lp.num_graphs, C=int(lp.degrees.shape[1]),
            nflat=int(lp.nbr_flat.shape[0]), ticks=-(-fixed // chk) * chk,
            chk=chk,
            edges=0 if lp.edge_pos_i is None else len(lp.edge_pos_i),
            incidence=0 if lp.inc_node is None else len(lp.inc_node)))
    return out


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    trace: object          # gossipbench.trace.Trace of the traced calls
    calls: int
    trials: int
    work: list             # call_work of each traced call
    priced: bool           # any traced call under a scenario or cost model
    peaks: dict            # gossipbench.peaks.read, or None off the card
    plan_setup_s: float

    def least_s(self, nbytes: float, ops: float, unit: str) -> float:
        """Least seconds of `nbytes` and `ops` operations on `unit`
        ("int32" or "f32")."""
        from .work.gossip import least_s

        return least_s(nbytes, ops, self.peaks["bytes_per_s"],
                       self.peaks[f"{unit}_per_s"])


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = HERE, program=None,
             start: float = _START) -> dict:
    """One run of cell `name`; returns the result line's object.

    `device` "cpu" runs the program's plain path on the CPU (tests only).
    `program`, where given, takes the place of a call of the port:
    ``program(port, x0, seeds, scenario)`` returns a dict of `_outputs`'
    keys, where ``port(x0, seeds)`` is the port's call and `scenario` the
    traffic file's entry (the control and the planted faults of
    `gossipbench.limits`)."""
    import numpy as np

    from . import check, registry
    from .reference import execute as ref_exec
    from .reference import plan as ref_plan
    from .work.gossip import call_work

    cell = registry.cell(name, root)
    cfg = registry.config(cell["config"], root)
    mix = registry.traffic(cell["traffic"], root)
    P = _import_program()
    import torch

    on_card = device == "cuda"
    dev = torch.device(device)
    if on_card:
        from repro_torch.kernels._build import build_all

        built = build_all(("sample_chunk", "pair_apply"))
    kernels = "built" if on_card and any(built.values()) else "found"
    log(f"kernels: {kernels} in {KERNEL_BUILD}")
    R = int(mix["trials_per_call"])
    V = 2 if cfg["weighted"] else 1
    t0 = time.perf_counter()
    plan, info = P.setup_plan(
        cfg["n"], c=cfg["c"], graph_seed=cfg["graph_seed"], a=cfg["a"],
        cell_max=cfg["cell_max"], seed=cfg["plan_seed"],
        rep_mode=cfg["rep_mode"], cache_dir=str(root / ".cache" / "plans"))
    plan_setup_s = time.perf_counter() - t0
    log(f"plan: {info['cache']} in {plan_setup_s:.3f} s, "
        f"{len(plan.levels)} levels")
    n = plan.graph.n

    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x0 = torch.randn((R, n), generator=gen, device=dev).cpu().numpy()
    base = int(torch.randint(0, 2 ** 32, (1,), generator=gen, device=dev,
                             dtype=torch.int64))

    def seeds_of(c: int) -> list:
        return [(base + c * R + r) & 0xFFFFFFFF for r in range(R)]

    scenarios = mix["scenarios"]
    models = [None if s["failures"] is None
              else P.FailureModel(**s["failures"]) for s in scenarios]
    cost = mix.get("cost")
    cost_model = P.CostModel(**cost) if cost else None
    opts = P.ExecOptions(backend="cuda" if on_card else "ref", device=device)
    kw = dict(eps=cfg["eps"], weighted=cfg["weighted"],
              fixed_ticks_scale=cfg["fixed_ticks_scale"])

    def call(c: int) -> dict:
        s = c % len(scenarios)

        def port(x, seeds):
            return _outputs(P.execute_plan(plan, x, seeds=seeds,
                                           failures=models[s],
                                           cost=cost_model, options=opts,
                                           **kw))

        if program is not None:
            return program(port, x0, seeds_of(c), scenarios[s])
        return port(x0, seeds_of(c))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for s in range(len(scenarios)):   # warm up: each scenario once
        call(-1 - s)
    sync()
    setup_s = time.perf_counter() - start
    log(f"set-up {setup_s:.3f} s")

    sampler = Sampler(seed, len(scenarios), cell["check"]["calls"],
                      cell["check"]["trials"], R)
    calls = []
    level_msgs = []

    def timed(c: int):
        t = time.perf_counter()
        out = call(c)
        sync()
        calls.append(Call(c, c % len(scenarios), seeds_of(c),
                          time.perf_counter() - t))
        sampler.offer(calls[-1], out)
        level_msgs.append(np.asarray(out["level_messages"]).sum(axis=0))

    tr = None
    w0 = time.perf_counter()
    if trace:
        from . import trace as trace_mod

        def traced():
            for c in range(int(cell["trace_calls"])):
                with torch.profiler.record_function(trace_mod.CALL):
                    timed(c)

        if on_card:
            tr = trace_mod.profile(torch, traced)
        else:
            traced()
    else:
        c = 0
        while time.perf_counter() - w0 < seconds:
            timed(c)
            c += 1
    window_s = time.perf_counter() - w0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    trials = R * len(calls)
    log(f"window: {len(calls)} calls, {trials} trials in {window_s:.3f} s")

    metrics = {}
    units = registry.metric_units(root)
    breakdown = None
    if not trace:
        e2e = {"trials_per_s": lambda: trials / window_s,
               "call_p95_ms": lambda: 1e3 * _p95([c.seconds for c in calls]),
               "setup_s": lambda: setup_s}
        for k in registry.metric_names(name, "end_to_end", root):
            metrics[k] = {"value": e2e[k](), "unit": units[k]}
    else:
        peaks = None
        if on_card:
            from . import peaks as peaks_mod

            peaks = peaks_mod.read(torch)
        shapes = level_shapes(plan, cfg)
        work = [call_work(shapes, R, n, V,
                          scenario=scenarios[c.scenario]["failures"]
                          is not None,
                          cost=cost is not None, level_messages=lm)
                for c, lm in zip(calls, level_msgs)]
        ctx = Context(trace=tr, calls=len(calls), trials=trials, work=work,
                      priced=cost is not None or any(
                          s["failures"] is not None for s in scenarios),
                      peaks=peaks, plan_setup_s=plan_setup_s)
        for k in registry.metric_names(name, "per_layer", root):
            value = registry.reader(k, root)(ctx)
            if value is not None:
                metrics[k] = {"value": value, "unit": units[k]}
        if tr is not None:
            breakdown = tr.breakdown()

    # the reference, once the program's state is freed
    del call
    if on_card:
        torch.cuda.empty_cache()
    readings = {}
    t0 = time.perf_counter()
    rplan = ref_plan.load_or_build(cfg, str(root / ".cache" / "reference"))
    bad = check.plan_mismatch(plan, rplan)
    readings["plan_mismatch"] = len(bad)
    if bad:
        log(f"plan arrays that differ: {bad[:20]}")
    for s, kept in enumerate(sampler.kept):
        for call_, rows, got in kept:
            x0r = x0[rows]
            want = ref_exec.run_blocks(
                rplan, torch.as_tensor(x0r, device=dev),
                [call_.seeds[r] for r in rows], eps=cfg["eps"],
                scale=cfg["fixed_ticks_scale"], weighted=cfg["weighted"],
                failures=scenarios[s]["failures"], cost=cost)
            for k, v in check.compare(got, want, x0r).items():
                readings[k] = max(readings.get(k, v), v)
    log(f"reference: {sum(len(k) for k in sampler.kept)} calls checked in "
        f"{time.perf_counter() - t0:.3f} s")
    correct, checks = check.verdict(readings, cell["limits"])

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": bool(correct), "attempted": trials, "failed": 0,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup"] = {"kernels": kernels, "plan_cache": info["cache"],
                    "plan_setup_s": plan_setup_s, "setup_s": setup_s}
    out["checks"] = checks
    return out


def _p95(values: list) -> float:
    """The 95th percentile of all values (linear between order
    statistics, as `statistics.quantiles` takes it inclusively)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossipbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import registry

    cell = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell['chips']}")
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except ForbiddenModules as e:
        log(f"loaded once the window closed, and not allowed: {e.args[0]}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"loaded and not allowed: {found}")
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
