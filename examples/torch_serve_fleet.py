"""Gossip-coordinated serving fleet demo on the PyTorch/CUDA port
(`examples/serve_fleet.py` on `repro_torch`).

Runs N simulated replicas (real BatchingEngine/PageTable scheduling,
stubbed model) under streaming Poisson traffic three times — once per
router — and prints throughput, admission latency, and control-plane
cost.  The point: power-of-two-choices routing from purely gossiped
load estimates tracks the centralized least-loaded oracle while paying
only the multiscale control-plane bytes.  The control plane's gossip
runs on the card (`--device cpu`: the plain backend on the CPU).

    PYTHONPATH=src python examples/torch_serve_fleet.py --replicas 16
"""
import argparse

from repro_torch.core import ExecOptions
from repro_torch.serve import ROUTERS, FleetConfig, run_fleet


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=240)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gossip-interval", type=int, default=4)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests/tick (0 = ~90%% of fleet capacity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def run(args, params=None) -> dict:
    """The script's run on parsed `args`; returns {router: FleetResult}
    and the p2c / oracle ratio.  (`params` is unused: the fleet's model
    is stubbed.)"""
    options = (ExecOptions(backend="ref", device="cpu")
               if args.device == "cpu" else None)
    results = {}
    for router in ROUTERS:
        cfg = FleetConfig(
            replicas=args.replicas, ticks=args.ticks,
            slots_per_replica=args.slots,
            gossip_interval=args.gossip_interval,
            arrival_rate=args.arrival_rate, router=router, seed=args.seed,
        )
        results[router] = run_fleet(cfg, options=options)

    print(f"fleet: {args.replicas} replicas x {args.slots} slots, "
          f"{args.ticks} ticks, arrival {cfg.resolved_rate():.2f} req/tick")
    hdr = (f"{'router':>12} {'tok/tick':>9} {'done':>6} {'adm.lat':>8} "
           f"{'p95':>6} {'pages':>6} {'ctrl bytes':>11}")
    print(hdr)
    for router, r in results.items():
        print(f"{router:>12} {r.throughput:>9.1f} {r.completed:>6d} "
              f"{r.admission_latency_mean:>8.2f} "
              f"{r.admission_latency_p95:>6.1f} "
              f"{r.page_utilization_mean:>6.2f} {r.control_bytes:>11d}")

    p2c, oracle = results["p2c_gossip"], results["oracle"]
    ratio = p2c.throughput / max(oracle.throughput, 1e-9)
    print(f"\np2c_gossip / oracle throughput: {ratio:.3f}")
    print(f"control plane: {p2c.control_rounds} rounds, "
          f"{p2c.control_messages} messages, "
          f"{p2c.bytes_per_round:.0f} bytes/round "
          f"({p2c.payload_values} payload values/packet)")
    if p2c.level_messages is not None:
        print(f"last round per-level messages: "
              f"{p2c.level_messages.tolist()}")
    return {"results": results, "ratio": ratio}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
