"""The paper's technique as gradient synchronization, on the
PyTorch/CUDA port: decentralized training with multiscale gossip vs
exact all-reduce (`examples/decentralized_consensus.py` on
`repro_torch`).

R replicas each train on their own batch shard; gradients are mixed by
the selected strategy under a static `SyncPlan` (plan/execute split).
Multiscale gossip keeps the replicas within a consensus ball (the
paper's eps) at a fraction of the flat-gossip message cost — printed
per step as `consensus`, alongside the modeled wire megabytes per sync.

Compression (`--compress topk|int8`) exchanges error-feedback
compressed payloads (unsent mass rides per-replica residuals in the
train state); `--rotate P` cycles the paper's randomized cells: a
P-entry permutation schedule re-assigns replicas to cells every step.
`--overlap` switches to the async pipeline (one-step-delayed
averaging): each step applies the previous step's mixed gradients
while the fresh ones ride the double-buffered `prev_grads` state (step
0 is warmup).  The replicas train on the card (`--device cpu` for the
CPU).

    PYTHONPATH=src python examples/torch_decentralized_consensus.py --strategy multiscale
    PYTHONPATH=src python examples/torch_decentralized_consensus.py \
        --strategy multiscale --compress topk --rotate 4 --overlap
"""
import argparse

from repro_torch.data import SyntheticLM
from repro_torch.dist import CompressionConfig, SyncConfig, suggest_levels
from repro_torch.models import Transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import sgdm
from repro_torch.train import (
    init_decentralized_state, make_decentralized_step, replicate,
)

CFG = ModelConfig(
    name="consensus-demo", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=1024,
    remat=False, dtype="float32",
)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="multiscale",
                    choices=["allreduce", "hierarchical", "ring", "multiscale"])
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--compress", default="none", choices=["none", "topk", "int8"],
                    help="error-feedback payload compression scheme")
    ap.add_argument("--topk-fraction", type=float, default=0.25)
    ap.add_argument("--rotate", type=int, default=0, metavar="P",
                    help="randomized-cell rotation period (0 = static cells)")
    ap.add_argument("--overlap", action="store_true",
                    help="one-step-delayed averaging: sync overlaps backward")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def run(args, params=None) -> dict:
    """The script's run on parsed `args`; returns each step's metrics.
    `params`: the model to replicate (a `Transformer` of `CFG`), drawn
    from seed 0 when None."""
    R = args.replicas
    cfg = CFG
    base = (Transformer(cfg, model_axis=1).init(seed=0, device=args.device)
            if params is None else params)
    params_r = replicate(base, R)
    opt = sgdm()
    levels = suggest_levels(R)
    sync = SyncConfig(
        strategy=args.strategy, levels=levels,
        compression=CompressionConfig(args.compress, args.topk_fraction),
        rotation_period=args.rotate,
        overlap="one_step" if args.overlap else "none",
    )
    state = init_decentralized_state(params_r, opt, sync=sync)
    print(f"strategy={args.strategy} R={R} levels={levels} "
          f"compress={args.compress} rotate={args.rotate or 'off'} "
          f"overlap={'one_step' if args.overlap else 'off'} "
          f"(paper rule: cells of ~R^(2/3))")
    step = make_decentralized_step(cfg, opt, lambda s: 5e-2, sync, R,
                                   device=args.device)
    data = SyntheticLM(cfg.vocab_size, seq_len=64, global_batch=R * 2, seed=0)
    history = []
    for s in range(args.steps):
        b = data.batch_at(s)
        batch = {k: v.reshape(R, 2, *v.shape[1:]) for k, v in b.items()}
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:3d}  loss={m['loss']:.3f}  "
                  f"consensus={m['consensus_distance']:.2e}  "
                  f"wire={m['wire_bytes'] / 2**20:.1f}MiB  "
                  f"overlap={m['sync_overlap_fraction']:.0f}")
    if args.strategy in ("allreduce", "hierarchical") and args.compress == "none":
        assert m["consensus_distance"] < 1e-6, "exact modes stay in sync"
        print("exact strategy: replicas remain bitwise-identical  OK")
    else:
        assert m["consensus_distance"] < 1e-1, "replicas drifted apart"
        print("gossip/compressed sync: replicas stay within the consensus "
              "ball (paper Thm 2 analogue)")
    return {"history": history}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
