"""The readings a cell's limits are set from, on the card, in one
process:

    python3 -m gossipbench.limits --workload <cell> --seeds 1,...,12 \
        --control-seeds 21,22,23 --fault-seeds 31,32,33 --seconds 3

* sound runs: the cell's own run (`run.run_cell`, a short window at the
  cell's load) on each of ``--seeds``; the largest reading of each
  number is its lower reading;
* the control: the reference in bfloat16, the precision below the
  float32 the configuration states, put in the program's place, on each
  of ``--control-seeds``; its smallest reading is the upper one;
* planted faults (`FAULTS`), each on ``--fault-seeds``: every one has to
  come out not correct.

The benchmark's own runs never run this.  It prints one JSON line a
run and writes them all to ``chiprun_out/limits/<cell>.json`` under the
checkout.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import registry, run


def _unchanged(port, x0, seeds, scenario):
    """The gossip leaves every value where it started."""
    out = port(x0, seeds)
    out["x_final"] = np.array(x0, np.float32)
    return out


def _half_batch(port, x0, seeds, scenario):
    """Only the first half of the trials runs; the second half repeats
    it."""
    h = len(seeds) // 2
    half = port(x0[:h], seeds[:h])
    idx = np.arange(len(seeds)) % h
    return {k: v[idx] for k, v in half.items()}


def _altered(port, x0, seeds, scenario):
    """One answer of each trial is off by one: its message count."""
    out = port(x0, seeds)
    out["messages"] = out["messages"] + 1
    return out


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}


def control(rplan: dict, cfg: dict, cost, device: str):
    """The reference in bfloat16 in the program's place."""
    import torch

    from .reference import execute

    def program(port, x0, seeds, scenario):
        return execute.run_blocks(
            rplan, torch.as_tensor(np.asarray(x0), device=device), seeds,
            eps=cfg["eps"], scale=cfg["fixed_ticks_scale"],
            weighted=cfg["weighted"], failures=scenario["failures"],
            cost=cost, dtype=torch.bfloat16)

    return program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossipbench.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    from .reference import plan as ref_plan

    cell = registry.cell(args.workload)
    cfg = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    rplan = ref_plan.load_or_build(cfg, str(run.HERE / ".cache" /
                                            "reference"))
    runs = [("sound", None, s) for s in ints(args.seeds)]
    runs += [("control", control(rplan, cfg, mix.get("cost"), "cuda"), s)
             for s in ints(args.control_seeds)]
    runs += [(name, fn, s) for name, fn in FAULTS.items()
             for s in ints(args.fault_seeds)]
    rows = []
    for kind, program, seed in runs:
        t0 = time.perf_counter()
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           program=program, start=time.perf_counter())
        row = {"kind": kind, "seed": seed, "correct": out["correct"],
               "attempted": out["attempted"],
               "seconds": time.perf_counter() - t0,
               "readings": {k: v["value"] for k, v in out["checks"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    dest = run.CHECKOUT / "chiprun_out" / "limits"
    dest.mkdir(parents=True, exist_ok=True)
    with open(dest / f"{args.workload}.json", "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
