"""Batched decode serving.

`make_serve_step(cfg)` builds the single-token step; `Generator` drives
it (greedy or temperature sampling, batched requests with per-slot stop
handling).  The prompt is teacher-forced through the same step, token by
token, as in the reference, so serving launches neither the wkv nor the
flash kernel: recurrent layers (rwkv, rglru) run their O(1) state
update, attention layers attend over a `max_len` KV cache ("local"
layers over a rotating one of their window) in plain tensor code, and
MoE feed-forwards route each step's tokens alone.  An encoder-decoder
(whisper) takes each request's frames: `generate` encodes them once
into the cache's memory, which every step cross-attends to.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.options import resolve_device
from ..models import decode_step, init_cache
from ..models.config import ModelConfig

__all__ = ["make_serve_step", "Generator"]


def make_serve_step(cfg: ModelConfig) -> Callable:
    def step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)
    return step


@dataclasses.dataclass
class Generator:
    """Serve `params` (a `models.Transformer`) on `device`, the card
    unless "cpu" is asked for; the parameters must lie there.

    Greedy sampling (temperature 0) is argmax, as in the reference.
    Temperature sampling draws from a `torch.Generator` seeded by
    `generate`'s `seed`: its tokens are not the reference's
    `jax.random.categorical` draws for the same seed.
    """

    cfg: ModelConfig
    params: torch.nn.Module
    max_len: int = 256
    temperature: float = 0.0
    eos_id: int = 1
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        where = self.params.embed.device
        if where.type != self._device.type or (
                self._device.index is not None and where != self._device):
            raise ValueError(f"the parameters lie on {where}, not on "
                             f"{self._device}")
        self._step = make_serve_step(self.cfg)
        self.last_stats: dict = {}

    def _prefill(self, cache, prompts_tb):
        """Teacher-force the prompt through the decode step; returns the
        last position's logits."""
        logits = None
        for tok in prompts_tb:
            logits, cache = self._step(self.params, cache, tok)
        return logits, cache

    def generate(
        self,
        prompts: np.ndarray,          # (B, P) int32 prompt tokens
        steps: int,
        seed: int = 0,
        frames=None,                  # (B, Se, D) for an encoder-decoder
    ) -> np.ndarray:
        B, P = prompts.shape
        cache = init_cache(self.params, self.cfg, batch=B,
                           max_len=self.max_len, frames=frames)
        gen = torch.Generator(device=self.params.embed.device)
        gen.manual_seed(seed)
        prompts_tb = torch.as_tensor(np.asarray(prompts).T,
                                     device=self.params.embed.device)
        logits, cache = self._prefill(cache, prompts_tb)
        out = []
        done = np.zeros(B, bool)
        live_tokens = 0
        tok = self._sample(logits, gen)
        for _ in range(steps):
            # finished slots emit eos_id forever; only live slots count
            # toward token throughput
            tok_np = np.where(done, self.eos_id, tok.cpu().numpy())
            live_tokens += int((~done).sum())
            out.append(tok_np)
            done |= tok_np == self.eos_id
            if done.all():
                break
            logits, cache = self._step(self.params, cache, tok_np)
            tok = self._sample(logits, gen)
        result = np.stack(out, axis=1)
        self.last_stats = {
            "prompt_len": P,
            "decode_steps": result.shape[1],
            "live_tokens": live_tokens,
            "emitted_tokens": int(result.size),
        }
        return result

    def _sample(self, logits, gen):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
