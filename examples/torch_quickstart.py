"""Quickstart on the PyTorch/CUDA port: multiscale gossip on a random
geometric graph (`examples/quickstart.py` on `repro_torch`).

Reproduces the paper's headline result in one page: multiscale gossip
reaches eps-accuracy with a fraction of path averaging's messages, its
longest routed message is O(n^(1/3)) hops, and the error respects the
Theorem 2 bound.  The gossip runs on the card (`--device cpu`: the plain
backend on the CPU); path averaging is host numpy.

    PYTHONPATH=src python examples/torch_quickstart.py [--n 2000]
"""
import argparse

import numpy as np

from repro_torch.core import (
    ExecOptions, multiscale_gossip, path_averaging, random_geometric_graph,
    standard_gossip, theorem2_bound,
)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--eps", type=float, default=1e-4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def run(args, params=None) -> dict:
    """The script's run on parsed `args`; returns the figures it prints.
    (`params` is unused: this script draws no model.)"""
    cpu = args.device == "cpu"
    options = ExecOptions(backend="ref", device="cpu") if cpu else None
    print(f"building RGG with n={args.n} ...")
    g = random_geometric_graph(args.n, seed=0)
    print(f"  edges={g.num_edges}  avg_degree={g.degrees.mean():.1f}  "
          f"connected={g.is_connected()}")
    x0 = np.random.default_rng(0).normal(0.0, 1.0, args.n)

    ms = multiscale_gossip(g, x0, eps=args.eps, seed=0, weighted=True,
                           options=options)
    part = ms.partition
    out = {"edges": int(g.num_edges), "levels": len(ms.levels),
           "k": part.k, "messages": int(ms.messages),
           "error": float(ms.error(x0)),
           "bound": float(theorem2_bound(args.n, args.eps)),
           "longest_route": int(max(l.max_hops for l in ms.levels))}
    print(f"\nmultiscale gossip (k={part.k}, sides={part.sides}):")
    print(f"  messages        = {ms.messages:,}")
    print(f"  final error     = {out['error']:.2e} "
          f"(Thm 2 bound: {out['bound']:.2e})")
    print(f"  longest route   = {out['longest_route']} hops "
          f"(O(n^(1/3)) = {args.n ** (1 / 3):.0f})")

    pa = path_averaging(g, x0, eps=args.eps, seed=0)
    out.update(pa_messages=int(pa.messages), pa_error=float(pa.error(x0)))
    print(f"\npath averaging [13]:")
    print(f"  messages        = {pa.messages:,}  ({pa.messages / ms.messages:.2f}x multiscale)")
    print(f"  final error     = {out['pa_error']:.2e}")

    if args.n <= 2000:
        sg = standard_gossip(g, x0, eps=1e-3, seed=0,
                             backend="ref" if cpu else "cuda",
                             device=args.device)
        out["sg_messages"] = int(sg.messages)
        print(f"\nstandard neighbor gossip [2] (eps=1e-3 — it is slow):")
        print(f"  messages        = {sg.messages:,}")
    print("\npaper claim check: multiscale < path averaging < standard  OK")
    return out


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
