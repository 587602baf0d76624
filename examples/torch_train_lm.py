"""End-to-end training driver on the PyTorch/CUDA port
(`examples/train_lm.py` on `repro_torch`): an LM trained with the full
substrate — deterministic data pipeline, AdamW + cosine schedule,
atomic checkpointing with auto-resume, metrics JSONL — on the card
(`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --preset smoke --steps 20

Presets (decoder-only llama-style):
  smoke : ~2M params
  25m   : ~25M params
  100m  : ~115M params (the assignment's "~100M for a few hundred steps")

Checkpoints go to ``repro_torch_train_lm`` under the system's temporary
directory unless ``--ckpt-dir`` is given.
"""
import argparse
import os
import tempfile

from repro_torch.data import SyntheticLM
from repro_torch.models import Transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import Trainer, init_train_state, make_train_step

PRESETS = {
    "smoke": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  head_dim=32, d_ff=256, vocab_size=2048, seq=128, batch=4),
    "25m": dict(num_layers=6, d_model=512, num_heads=8, num_kv_heads=4,
                head_dim=64, d_ff=1536, vocab_size=8192, seq=256, batch=8),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768, seq=512, batch=8),
}


def preset_config(preset: str) -> ModelConfig:
    p = PRESETS[preset]
    return ModelConfig(
        name=f"train-lm-{preset}", family="dense",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=p["vocab_size"],
        tie_embeddings=True, remat=False, dtype="float32",
    )


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def run(args, params=None) -> dict:
    """The script's run on parsed `args`; returns the run's metrics and
    the step it resumed from.  `params`: the model (a `Transformer` of
    the preset's config), drawn from seed 0 when None."""
    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    model = Transformer(cfg, model_axis=1)
    print(f"model: {model.num_params / 1e6:.1f}M params")

    opt = adamw(weight_decay=0.01)
    lr = cosine_schedule(args.lr, warmup=20, total=args.steps)
    data = SyntheticLM(cfg.vocab_size, seq_len=p["seq"],
                       global_batch=p["batch"], seed=0)
    step_fn = make_train_step(cfg, opt, lr, dp=None, device=args.device)
    if params is None:
        params = model.init(seed=0, device=args.device)
    state = init_train_state(params, opt)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    trainer = Trainer(
        step_fn, state, data,
        ckpt_dir=args.ckpt_dir, save_every=50,
        log_path=os.path.join(args.ckpt_dir, "metrics.jsonl"),
        device=args.device,
    )
    start = trainer.step
    history = trainer.run(args.steps)
    first, last = history[0], history[-1]
    print(f"step {first['step']}: loss={first['loss']:.3f}")
    print(f"step {last['step']}: loss={last['loss']:.3f} "
          f"({last['sec_per_step']:.2f}s/step)")
    assert last["loss"] < first["loss"], "loss should decrease"
    print(f"checkpoints under {args.ckpt_dir} — rerun to auto-resume")
    return {"history": history, "start_step": start}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
