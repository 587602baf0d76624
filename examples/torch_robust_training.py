"""Fault-tolerant decentralized training on the PyTorch/CUDA port:
failure injection + robust aggregation + EF-residual recovery
(`examples/robust_training.py` on `repro_torch`).

R replicas train with multiscale gossip sync while a static
`SyncFailureModel` injects replica faults each sync step — churned
replicas (down, transmit nothing), stragglers (miss the round), and
Byzantine replicas (transmit 10x-scaled corrupted gradients).  The
chosen `--aggregation` defends the mix:

* ``survivor_weighted`` — renormalizes the doubly-stochastic gossip
  mass over the live replicas (the natural defense for absence faults);
* ``trimmed_mean`` / ``coordinate_median`` — consensus-style robust
  statistics that bound the Byzantine contribution;
* ``mean`` — no defense (watch the loss blow up under --byzantine).

With ``--compress`` the error-feedback residuals double as the recovery
buffer: a dropped replica's whole accumulator (gradient + residual)
stays in its residual — bitwise, nothing is lost — and re-enters the
stream the moment it rejoins.

Per step the run prints the degradation trio next to the loss:
`survivor_err` (consensus distance over LIVE replicas only),
`eff_frac` (live fraction this sync), `rejected` (Byzantine gradients
excluded by the robust reduction).  The replicas train on the card
(`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_robust_training.py \
        --churn 0.25 --byzantine 0.125 --aggregation trimmed_mean
    PYTHONPATH=src python examples/torch_robust_training.py \
        --churn 0.25 --aggregation survivor_weighted --compress topk
"""
import argparse

import numpy as np

from repro_torch.data import SyntheticLM
from repro_torch.dist import (
    AGGREGATIONS, CompressionConfig, SyncConfig, SyncFailureModel,
    suggest_levels,
)
from repro_torch.models import Transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import sgdm
from repro_torch.train import (
    init_decentralized_state, make_decentralized_step, replicate,
)

CFG = ModelConfig(
    name="robust-demo", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=1024,
    remat=False, dtype="float32",
)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="multiscale",
                    choices=["allreduce", "hierarchical", "ring", "multiscale"])
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--churn", type=float, default=0.25,
                    help="fraction of replicas down each sync")
    ap.add_argument("--stragglers", type=float, default=0.0,
                    help="fraction of replicas missing each sync round")
    ap.add_argument("--byzantine", type=float, default=0.0,
                    help="fraction transmitting corrupted gradients")
    ap.add_argument("--byzantine-scale", type=float, default=10.0)
    ap.add_argument("--aggregation", default="survivor_weighted",
                    choices=list(AGGREGATIONS))
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"],
                    help="EF compression (residuals = the recovery buffer)")
    ap.add_argument("--topk-fraction", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
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
    failures = SyncFailureModel(
        churn_fraction=args.churn,
        straggler_fraction=args.stragglers,
        byzantine_fraction=args.byzantine,
        byzantine_scale=args.byzantine_scale,
        seed=args.seed,
    )
    sync = SyncConfig(
        strategy=args.strategy, levels=suggest_levels(R),
        compression=CompressionConfig(args.compress, args.topk_fraction),
        aggregation=args.aggregation,
        failures=failures if failures.active else None,
    )
    state = init_decentralized_state(params_r, opt, sync=sync)
    print(f"strategy={args.strategy} R={R} agg={args.aggregation} "
          f"churn={args.churn:g} stragglers={args.stragglers:g} "
          f"byzantine={args.byzantine:g}x{args.byzantine_scale:g} "
          f"compress={args.compress}")
    step = make_decentralized_step(cfg, opt, lambda s: 5e-2, sync, R,
                                   device=args.device)
    data = SyntheticLM(cfg.vocab_size, seq_len=64, global_batch=R * 2, seed=0)
    losses, history = [], []
    for s in range(args.steps):
        b = data.batch_at(s)
        batch = {k: v.reshape(R, 2, *v.shape[1:]) for k, v in b.items()}
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        losses.append(m["loss"])
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:3d}  loss={losses[-1]:.3f}  "
                  f"survivor_err={m['survivor_consensus_error']:.2e}  "
                  f"eff_frac={m['effective_replica_fraction']:.2f}  "
                  f"rejected={m['rejected_gradient_count']:.0f}")
    assert np.isfinite(losses[-1]), "training diverged"
    if failures.active:
        assert m["effective_replica_fraction"] < 1.0
        print(f"faulty sync survived: mean loss last 5 = "
              f"{np.mean(losses[-5:]):.3f} (first 5 = "
              f"{np.mean(losses[:5]):.3f})")
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), (
            "loss failed to decrease under faults")
    print("robust decentralized training OK")
    return {"history": history}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
