"""Batched serving demo on the PyTorch/CUDA port
(`examples/serve_decode.py` on `repro_torch`): train-free random-weight
model, batched generation through the KV-cache decode path (the same
`decode_step` the decode_32k / long_500k dry-run cells trace), on the
card (`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch rwkv6-3b
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.models import Transformer
from repro_torch.serve import Generator


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def run(args, params=None) -> dict:
    """The script's run on parsed `args`; returns the generated tokens
    and the generator's stats.  `params`: the model (a `Transformer` of
    the reduced config), drawn from seed 0 when None."""
    cfg = reduce_config(get_config(args.arch))
    model = Transformer(cfg, model_axis=1)
    if params is None:
        params = model.init(seed=0, device=args.device)
    print(f"{cfg.name}: {model.num_params / 1e6:.2f}M params (reduced config)")

    frames = None
    if cfg.encoder_layers:
        frames = np.random.default_rng(0).normal(
            0, 1, (args.batch, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32)
    gen = Generator(cfg, params, max_len=128, temperature=0.8,
                    device=args.device)
    prompts = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (args.batch, 8)
    ).astype(np.int32)
    # the first generate's time is reported on its own, as the
    # reference reports its compile; here it is the first call's set-up
    t0 = time.time()
    gen.generate(prompts, steps=1, seed=0, frames=frames)
    jit_warmup_s = time.time() - t0
    t0 = time.time()
    out = gen.generate(prompts, steps=args.steps, seed=0, frames=frames)
    dt = time.time() - t0
    live = gen.last_stats["live_tokens"]
    print(f"jit_warmup_s: {jit_warmup_s:.2f}")
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({live / dt:.0f} live tok/s batched, "
          f"{live}/{out.size} live)")
    print("sample token ids:", out[0][:16].tolist())
    return {"tokens": out, "stats": dict(gen.last_stats), "seconds": dt}


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
