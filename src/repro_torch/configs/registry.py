"""Architecture registry + assigned input shapes + reduced smoke configs.

Shapes (assignment): seq_len x global_batch.  decode_* / long_* lower
`serve_step` (one token against a seq_len KV cache); long_500k requires
sub-quadratic sequence mixing and is skipped for pure full-attention
archs (`ModelConfig.supports_long_context`), recorded per-cell in
EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "reduce_config", "cell_is_runnable"]

ARCH_IDS = (
    "whisper-tiny",
    "recurrentgemma-9b",
    "yi-6b",
    "gemma-7b",
    "gemma2-27b",
    "llama3.2-3b",
    "llama4-maverick-400b-a17b",
    "grok-1-314b",
    "qwen2-vl-72b",
    "rwkv6-3b",
)

_MODULE_OF = {
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "yi-6b": "yi_6b",
    "gemma-7b": "gemma_7b",
    "gemma2-27b": "gemma2_27b",
    "llama3.2-3b": "llama3_2_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "grok-1-314b": "grok_1",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-3b": "rwkv6_3b",
}

# name -> (seq_len, global_batch, mode)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULE_OF[arch_id]}", __package__)
    return mod.CONFIG


def cell_is_runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Skip rules from the assignment; returns (runnable, reason)."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "full attention is quadratic at 524k context (skip rule)"
    return True, ""


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests: small width/depth,
    few experts, tiny vocab, short windows."""
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=max(len(cfg.block_unit), 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.kv_heads, 2) if cfg.num_kv_heads else None,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=16 if cfg.window else None,
        rwkv_head_dim=16,
        remat=False,
    )
    if cfg.num_experts:
        changes.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, encoder_seq=24)
    if cfg.mrope_sections:
        changes.update(mrope_sections=(2, 3, 3))  # sums to head_dim//2
    if cfg.query_scale:
        changes.update(query_scale=(64 / 4) ** -0.5)
    return dataclasses.replace(cfg, **changes)
