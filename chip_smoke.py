#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the main
path — `repro_torch.core.multiscale_gossip`, the paper's Algorithm 1 in
its fixed-iterations large-n configuration — at n=10^5 and n=10^6 nodes,
the matmul backend at n=20000 and `synchronous_multiscale` at n=2000,
and checks the results against the repository's recorded message counts
and errors.  Any failed check raises, and the script exits non-zero.

Output: progress lines, the card's name and power limit, one JSON line
``{"kernels": [...]}`` (per kernel: its launches on each path that runs
it, each path counted on its own, error against its plain version, its
time, the plain version's, the least time the card could take, and a
PyTorch library call's where one exists), and
last ``{"ok": true, "device": {...}}``.  The measurements also go to
``chiprun_out/chip_smoke.json``.  Without CUDA, or without the rest of
the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the large-n fixed-iterations configuration (benchmarks/large_n.py):
# weighted, fixed_ticks_scale=0.2, eps=1e-3, graph_seed=1000+n, seed=0,
# x0 = default_rng(n).normal(0, 1, n); recorded messages and errors
LARGE_N = {
    20_000: (1_008_706, 0.0017078202335822647),
    100_000: (4_230_486, 0.000994252358016139),
    1_000_000: (79_785_918, 0.0003279788359757681),
}
FI = dict(eps=1e-3, seed=0, weighted=True, fixed_ticks_scale=0.2)
# pair_apply launches of one FI trial: at n=10^5, 1 chunk on each of the
# five finest levels, 3 on level 2, 26 on level 1
MAIN_PATH_LAUNCHES = {100_000: 33, 1_000_000: 120}
SYNC_CHUNK = 8  # synchronous_multiscale's rounds per cell_mixing launch
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores; the PCIe part is slower
PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.name = torch.cuda.get_device_name(0)
        part = "pcie" if "PCIE" in self.name.upper() else "sxm"
        self.hbm, self.f32 = PEAKS[part]
        self.report: dict = {"device": self.name}
        self.kernels: dict = {}

    # ---------------------------------------------------------- helpers
    def time_ms(self, fn, reps: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound_ms(self, nbytes: float, flops: float):
        t_bytes, t_ops = nbytes / self.hbm, flops / self.f32
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def gen(self, seed: int):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def zero_counts(self):
        from repro_torch.kernels.cell_mixing import cell_mixing
        from repro_torch.kernels.pair_apply import pair_apply

        pair_apply.launches = 0
        cell_mixing.launches = 0

    def read_counts(self):
        from repro_torch.kernels.cell_mixing import cell_mixing
        from repro_torch.kernels.pair_apply import pair_apply

        return pair_apply.launches, cell_mixing.launches

    # ----------------------------------------------------------- phases
    def build(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(out)
        self.report["nvidia_smi"] = out
        from repro_torch.kernels._build import build_all

        t0 = time.perf_counter()
        logs = build_all()
        dt = time.perf_counter() - t0
        log(f"[build] both kernels built in {dt:.2f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
        self.report["build_s"] = dt

    def prng(self, lp, T):
        """Threefry on the card against threefry on the CPU, bitwise."""
        torch = self.torch
        from repro_torch.core import prng, sample_schedule

        B = lp.num_graphs
        triples = ((0, 0, 0), (0, 5, 1663), (7, 2, 100), (123, 1, 49),
                   (2**31 + 5, 3, 7), (1, 0, 63), (2, 4, 4095), (99, 1, 1),
                   (2**32 - 1, 2, 31), (31337, 5, 2**20))
        for seed, level, t in triples:
            draws = []
            for dev in ("cpu", self.dev):
                key = prng.fold_in(prng.PRNGKey(seed, dev), level)
                ks = prng.split(prng.fold_in(key, t), 4)
                draws.append(prng.uniform(ks, (B,)).view(torch.int32).cpu())
            check(torch.equal(*draws),
                  f"prng draws differ at {(seed, level, t)}")
        from repro_torch.core import CsrGraphs

        fields = {}
        for loss_p in (None, 0.9):
            s = []
            for dev in ("cpu", self.dev):
                adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat,
                                lp.degrees, lp.n_nodes).to_device(dev)
                key = prng.fold_in(prng.PRNGKey(0, dev), 0)[None]
                s.append(sample_schedule(torch.arange(T), key, adj, loss_p))
            flips = {f: int((a.cpu() != b.cpu()).sum())
                     for f, a, b in zip(s[0]._fields, s[0], s[1])}
            fields[str(loss_p)] = flips
            # loss_p goes through floor(log u / log p): a one-ulp log
            # difference between devices may not flip any outcome
            check(not any(flips.values()),
                  f"schedule differs card vs CPU at loss_p={loss_p}: {flips}")
        log(f"[prng] card == CPU bitwise for {len(triples)} (seed, level, t) "
            f"draws and every field of the n=1e5 finest-level schedule, "
            f"without loss and at loss_p=0.9")
        self.report["prng_loss_mismatch"] = fields["0.9"]
        return s[1]

    def pair_apply(self, lp, sched, T):
        torch = self.torch
        from repro_torch.kernels.pair_apply import pair_apply, pair_apply_ref

        worst = 0.0

        def compare(x, i, j, ui, uj, label, **kw):
            nonlocal worst
            got = pair_apply(x, i, j, ui, uj, **kw)
            want = pair_apply_ref(x, i, j, ui, uj)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) if got.numel() else 0.0
            worst = max(worst, err)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"pair_apply kernel != plain version at {label} "
                  f"(max abs err {err})")

        B, C, V = lp.num_graphs, lp.node_mask.shape[1], 2
        x = torch.randn((B, C, V), generator=self.gen(1), device=self.dev)
        i = sched.i.reshape(T, B).contiguous()
        j = sched.j.reshape(T, B).contiguous()
        act = sched.valid.reshape(T, B).contiguous()
        compare(x, i, j, act, act, f"n=1e5 finest level {(B, C, V, T)}")
        for C2 in (4, 9, 16, 49, 130):
            for V2, B2, T2 in ((2, 4099, 64), (1, 777, 50)):
                g = self.gen(C2 * 1000 + V2)
                xr = torch.randn((B2, C2, V2), generator=g, device=self.dev)
                ir = torch.randint(0, C2, (T2, B2), generator=g,
                                   device=self.dev, dtype=torch.int32)
                jr = torch.randint(0, C2, (T2, B2), generator=g,
                                   device=self.dev, dtype=torch.int32)
                same = torch.rand((T2, B2), generator=g, device=self.dev) < 0.1
                jr = torch.where(same, ir, jr)  # i == j ticks
                ui = torch.rand((T2, B2), generator=g, device=self.dev) < 0.7
                uj = torch.rand((T2, B2), generator=g, device=self.dev) < 0.8
                compare(xr, ir, jr, ui, uj, f"random {(B2, C2, V2, T2)}")
                if C2 == 49:
                    compare(xr, ir, jr, ui, uj,
                            f"device-memory state {(B2, C2, V2, T2)}",
                            smem_cap=0)
        ms = self.time_ms(lambda: pair_apply(x, i, j, act, act), reps=50)
        plain = self.time_ms(lambda: pair_apply_ref(x, i, j, act, act),
                             reps=3, warmup=1)
        nbytes = 2 * B * C * V * 4 + T * B * (4 + 4 + 1 + 1)
        bound, by = self.bound_ms(nbytes, 2 * T * B * V)
        log(f"[pair_apply] bitwise == plain version at n=1e5 finest level "
            f"and C in (4, 9, 16, 49, 130); at {(B, C, V, T)}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by})")
        self.kernels["pair_apply"] = dict(
            name="pair_apply", route="cuda",
            source="src/repro_torch/csrc/pair_apply.cu",
            replaces="src/repro/kernels/pair_apply/kernel.py:40",
            launches=None, max_abs_err=worst, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=dict(B=B, C=C, V=V, T=T))

    def cell_mixing(self, plan20k):
        torch = self.torch
        from repro_torch.core import CsrGraphs, compose_schedule, prng
        from repro_torch.core import sample_schedule
        from repro_torch.kernels.cell_mixing import (
            cell_mixing, cell_mixing_ref, mixing_matrix)
        from repro_torch.kernels.cell_mixing.ref import no_tf32

        lp = plan20k.levels[0]
        B, C = lp.node_mask.shape
        w = torch.as_tensor(mixing_matrix(lp.neighbors, lp.degrees,
                                          lp.n_nodes), device=self.dev)
        worst = 0.0
        for d in (2, 33):
            x = torch.randn((B, C, d), generator=self.gen(d), device=self.dev)
            for rounds in (1, 8):
                got = cell_mixing(w, x, rounds=rounds)
                want = cell_mixing_ref(w, x, rounds=rounds)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"cell_mixing != plain version at {(B, C, d, rounds)} "
                      f"(max abs err {err})")
                check(torch.allclose(got.sum(1), x.sum(1), rtol=1e-4,
                                     atol=1e-4),
                      f"cell_mixing lost mass at {(B, C, d, rounds)}")
        # the matmul backend's input: one composed chunk at n=20000
        T = 50
        adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                        lp.n_nodes).to_device(self.dev)
        s = sample_schedule(torch.arange(T), prng.PRNGKey(0, self.dev)[None],
                            adj, None)
        act = s.valid.reshape(T, B)
        m = compose_schedule(C, s.i.reshape(T, B), s.j.reshape(T, B), act, act)
        x = torch.randn((B, C, 2), generator=self.gen(5), device=self.dev)
        got, want = cell_mixing(m, x), cell_mixing_ref(m, x)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"cell_mixing != plain version on a composed chunk ({err})")
        ms = self.time_ms(lambda: cell_mixing(m, x), reps=100)
        plain = self.time_ms(lambda: cell_mixing_ref(m, x), reps=100)
        with no_tf32():
            library = self.time_ms(lambda: torch.bmm(m, x), reps=100)
        bound, by = self.bound_ms((B * C * C + 2 * B * C * 2) * 4,
                                  2 * B * C * C * 2)
        log(f"[cell_mixing] allclose 1e-5 and mass kept at rounds 1, 8; at "
            f"{(B, C, 2)}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch.bmm {library:.4f} ms, bound {bound:.4f} ms ({by})")
        self.kernels["cell_mixing"] = dict(
            name="cell_mixing", route="cuda",
            source="src/repro_torch/csrc/cell_mixing.cu",
            replaces="src/repro/kernels/cell_mixing/kernel.py:27",
            launches=None, max_abs_err=worst, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=library,
            shape=dict(B=B, m=C, d=2, rounds=1))

    def setup(self, n):
        import numpy as np
        from repro_torch.core import build_plan, random_geometric_graph

        t0 = time.perf_counter()
        g = random_geometric_graph(n, seed=1000 + n)
        t1 = time.perf_counter()
        plan = build_plan(g, seed=0)
        t2 = time.perf_counter()
        x0 = np.random.default_rng(n).normal(0, 1, n)
        return g, plan, x0, t1 - t0, t2 - t1

    def run(self, g, plan, x0, backend):
        import repro_torch.core as P

        opts = P.ExecOptions(backend=backend)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = P.multiscale_gossip(g, x0, plan=plan, options=opts, **FI)
        self.torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    @staticmethod
    def fi_chunks(plan, check_every: int = 64) -> int:
        """Value-pass launches of one FI trial as the plan gives them: each
        level runs its fixed tick budget in whole chunks."""
        from repro_torch.core import fi_ticks

        total = 0
        for lp in plan.levels:
            fixed = fi_ticks(int(lp.n_nodes.max()), FI["eps"],
                             FI["fixed_ticks_scale"],
                             quadratic=(lp.kind == "overlay"))
            total += -(-fixed // min(check_every, fixed))
        return total

    def large_n(self, n, g, plan, x0, graph_s, plan_s):
        """The main path: FI multiscale gossip through the pair_apply
        kernel, against the recorded count/error and the plain backend."""
        import numpy as np

        want_msgs, want_err = LARGE_N[n]
        self.zero_counts()
        res, exec_s = self.run(g, plan, x0, "cuda")
        launches, mixing = self.read_counts()
        err = res.error(x0)
        log(f"[main n={n}] cuda backend: messages {res.messages}, error "
            f"{err:.9f}, pair_apply launches {launches}; graph {graph_s:.2f} "
            f"s, plan {plan_s:.2f} s, execute {exec_s:.3f} s")
        want_launches = self.fi_chunks(plan)
        check(launches == want_launches == MAIN_PATH_LAUNCHES[n],
              f"n={n}: pair_apply launched {launches} times; the plan gives "
              f"{want_launches}, recorded {MAIN_PATH_LAUNCHES[n]}")
        check(mixing == 0, f"n={n}: the cuda backend launched cell_mixing")
        check(res.messages == want_msgs,
              f"n={n}: messages {res.messages} != recorded {want_msgs}")
        check(abs(err - want_err) <= 1e-6,
              f"n={n}: error {err} not within 1e-6 of {want_err}")
        check(np.isfinite(res.x_final).all() and res.x_final.shape == (n,),
              "x_final is not n finite values")
        row = dict(n=n, levels=len(plan.levels), messages=res.messages,
                   error=err, pair_apply_launches=launches,
                   graph_s=graph_s, plan_s=plan_s, execute_s=exec_s)
        ref, ref_s = self.run(g, plan, x0, "ref")
        check(np.array_equal(ref.x_final.view(np.int32),
                             res.x_final.view(np.int32)),
              f"n={n}: cuda x_final != ref backend x_final")
        check(ref.messages == res.messages
              and np.array_equal(ref.node_sends, res.node_sends),
              f"n={n}: accounting differs between backends")
        log(f"[main n={n}] ref backend bitwise equal; execute {ref_s:.3f} s")
        row["execute_ref_s"] = ref_s
        # a second, warm run of the kernel path, then a traced one
        _, row["execute_warm_s"] = self.run(g, plan, x0, "cuda")
        row.update(self.profile(n, g, plan, x0, row["execute_warm_s"]))
        self.report[f"large_n_{n}"] = row
        return launches

    def profile(self, n, g, plan, x0, warm_s):
        """Device time by kernel over one traced execute: the device's
        busy time against the untraced warm wall clock gives its idle
        share."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, traced_s = self.run(g, plan, x0, "cuda")
        # device-side events only: the CPU-side op that launched a kernel
        # carries the same device time again
        cuda = self.torch.autograd.DeviceType.CUDA
        rows = [(float(ev.self_device_time_total), int(ev.count), ev.key)
                for ev in prof.key_averages()
                if ev.device_type == cuda and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            log(f"[profile n={n}] the trace holds no device time: not "
                f"measured")
            return {"profile": "not measured"}
        pair_ms = sum(r[0] for r in rows if "pair_apply" in r[2]) / 1e3
        out = {
            "device_busy_ms": busy_ms,
            "device_launches": sum(r[1] for r in rows),
            "traced_wall_s": traced_s,
            "idle_share": 1.0 - busy_ms / (warm_s * 1e3),
            "pair_apply_device_ms": pair_ms,
            "top_kernels": [dict(name=k[:160], device_ms=us / 1e3, count=c)
                            for us, c, k in rows[:10]],
        }
        log(f"[profile n={n}] device busy {busy_ms:.2f} ms in "
            f"{out['device_launches']} launches over a {warm_s * 1e3:.1f} ms "
            f"warm execute (idle share {out['idle_share']:.3f}); pair_apply "
            f"{pair_ms:.3f} ms")
        for row in out["top_kernels"][:5]:
            log(f"[profile n={n}]   {row['device_ms']:.3f} ms x{row['count']}"
                f" {row['name'][:100]}")
        return out

    def matmul(self, g, plan, x0):
        """FI multiscale gossip at n=20000 through compose_schedule and the
        cell_mixing kernel, against the recorded count and the cuda
        backend."""
        import numpy as np

        self.zero_counts()
        mm, mm_s = self.run(g, plan, x0, "matmul")
        pairs, launches = self.read_counts()
        want_launches = self.fi_chunks(plan)
        check(launches == want_launches,
              f"n=20000 matmul: cell_mixing launched {launches} times, the "
              f"plan gives {want_launches}")
        check(pairs == 0, "the matmul backend launched pair_apply")
        cu, _ = self.run(g, plan, x0, "cuda")
        check(mm.messages == LARGE_N[20_000][0] == cu.messages,
              f"n=20000 matmul messages {mm.messages} != "
              f"{LARGE_N[20_000][0]}")
        check(np.allclose(mm.x_final, cu.x_final, rtol=1e-4, atol=2e-4),
              "n=20000 matmul x_final not allclose to the cuda backend")
        log(f"[matmul n=20000] messages {mm.messages}, max |matmul - cuda| "
            f"{float(np.abs(mm.x_final - cu.x_final).max()):.3e}, execute "
            f"{mm_s:.3f} s, cell_mixing launches {launches}")
        self.report["matmul_20000"] = dict(
            messages=mm.messages, execute_s=mm_s,
            cell_mixing_launches=launches)
        return launches

    def synchronous(self):
        """synchronous_multiscale at n=2000 through the cell_mixing kernel,
        against its plain version on the CPU."""
        import numpy as np
        import repro_torch.core as P

        n = 2000
        g = P.random_geometric_graph(n, seed=1000 + n)
        x0 = np.random.default_rng(n).normal(0, 1, n)
        self.zero_counts()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        sy = P.synchronous_multiscale(g, x0, eps=1e-4, chunk=SYNC_CHUNK)
        sy_s = time.perf_counter() - t0
        pairs, launches = self.read_counts()
        host = P.synchronous_multiscale(g, x0, eps=1e-4, chunk=SYNC_CHUNK,
                                        device="cpu")
        check(sy.messages == host.messages
              and sy.rounds_per_level == host.rounds_per_level,
              f"synchronous messages {sy.messages} != plain {host.messages}")
        check(np.allclose(sy.x_final, host.x_final, rtol=1e-4, atol=1e-5),
              "synchronous x_final not allclose to the plain version")
        check(sy.error(x0[:, None]) < 1e-2, "synchronous run did not average")
        want_launches = sum(r for _, r in sy.rounds_per_level) // SYNC_CHUNK
        check(launches == want_launches > 0,
              f"synchronous: cell_mixing launched {launches} times, its "
              f"rounds per level {sy.rounds_per_level} give {want_launches}")
        check(pairs == 0, "synchronous_multiscale launched pair_apply")
        log(f"[synchronous n=2000] messages {sy.messages}, rounds per level "
            f"{sy.rounds_per_level}, error {sy.error(x0[:, None]):.3e}, "
            f"{sy_s:.3f} s, cell_mixing launches {launches}")
        self.report["synchronous_2000"] = dict(
            messages=sy.messages, seconds=sy_s, cell_mixing_launches=launches)
        return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    smoke = Smoke(torch)
    smoke.build()

    g5, plan5, x05, graph5, pl5 = smoke.setup(100_000)
    lp0 = plan5.levels[0]
    T0 = 50  # the finest level's FI chunk at n=1e5
    sched = smoke.prng(lp0, T0)
    smoke.pair_apply(lp0, sched, T0)
    g2, plan2, x02, _, _ = smoke.setup(20_000)
    smoke.cell_mixing(plan2)

    # each path runs with the counts set to 0 just before it and read just
    # after; `launches` is the count of the kernel's own first path
    main5 = smoke.large_n(100_000, g5, plan5, x05, graph5, pl5)
    del g5, plan5
    g6, plan6, x06, graph6, pl6 = smoke.setup(1_000_000)
    main6 = smoke.large_n(1_000_000, g6, plan6, x06, graph6, pl6)
    del g6, plan6
    smoke.kernels["pair_apply"].update(
        launches=main5, path="multiscale_gossip FI n=100000, backend cuda",
        launches_by_path={
            "multiscale_gossip FI n=100000, backend cuda": main5,
            "multiscale_gossip FI n=1000000, backend cuda": main6})
    mm = smoke.matmul(g2, plan2, x02)
    sy = smoke.synchronous()
    smoke.kernels["cell_mixing"].update(
        launches=mm, path="multiscale_gossip FI n=20000, backend matmul",
        launches_by_path={
            "multiscale_gossip FI n=20000, backend matmul": mm,
            "synchronous_multiscale n=2000": sy})

    total = time.perf_counter() - t_start
    smoke.report["total_s"] = total
    smoke.report["kernels"] = list(smoke.kernels.values())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(smoke.report, indent=1, default=float))
    log(f"[done] all phases passed in {total:.1f} s")
    kernels = [{k: v for k, v in row.items() if k != "shape"}
               for row in smoke.kernels.values()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
