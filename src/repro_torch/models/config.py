"""Model configuration covering the 10 assigned architectures.

One `ModelConfig` describes any member of the zoo; per-arch files in
`repro.configs` instantiate it with the published numbers.  Layer
patterns are expressed as a repeating unit of block kinds so the stack
can be lowered as scan-over-layers per homogeneous group (compile-time
control at 500k-seq / 80-layer scale).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: Optional[int] = None      # None => MHA
    head_dim: Optional[int] = None          # None => d_model // num_heads

    # --- attention variants ---
    rope_theta: float = 10_000.0
    window: Optional[int] = None            # sliding-window width
    attn_logit_softcap: Optional[float] = None   # gemma2 attention softcap
    final_logit_softcap: Optional[float] = None  # gemma2 LM-head softcap
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    query_scale: Optional[float] = None     # gemma2: (d_model/num_heads)^-0.5

    # --- per-layer pattern; one entry per layer in the repeating unit ---
    # kinds: "attn" (global), "local" (sliding window), "rglru", "rwkv"
    block_unit: tuple[str, ...] = ("attn",)

    # --- mlp ---
    mlp_kind: str = "swiglu"                # swiglu | geglu | gelu
    post_norms: bool = False                # gemma2: post-sublayer RMSNorms

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper: 30 s of 10 ms frames / 2

    # --- ssm details ---
    rglru_conv_width: int = 4
    rwkv_head_dim: int = 64

    # --- modality frontend stub ---
    frontend: str = "none"                  # none | audio_frames | vision_patches

    # --- embedding / norm / numerics ---
    scale_embeddings: bool = False          # gemma: * sqrt(d_model)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # --- training-memory policy (per-arch; see DESIGN.md §6) ---
    optimizer: str = "adamw"                # adamw | adafactor
    remat: bool = True
    scan_unroll: bool = False               # unroll scan-over-layers (the
                                            # dry-run's depth variants use
                                            # this for loop-aware costing)

    # ------------------------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_width(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_kinds(self) -> tuple[str, ...]:
        """Expanded per-layer kind list of length num_layers (decoder)."""
        unit = self.block_unit
        kinds = tuple(unit[i % len(unit)] for i in range(self.num_layers))
        return kinds

    def scan_groups(self) -> list[tuple[tuple[str, ...], int]]:
        """(unit, repeats) groups covering layer_kinds(); the trailing
        partial unit (if any) becomes its own group of repeat 1."""
        unit = self.block_unit
        full, rem = divmod(self.num_layers, len(unit))
        groups: list[tuple[tuple[str, ...], int]] = []
        if full:
            groups.append((unit, full))
        if rem:
            groups.append((unit[:rem], 1))
        return groups

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rglru", "rwkv") for k in self.layer_kinds())

    @property
    def supports_long_context(self) -> bool:
        """True when no layer needs an unbounded KV cache (SSM / hybrid
        with bounded local windows) — the long_500k eligibility rule."""
        for kind in self.layer_kinds():
            if kind == "attn":
                return False
            if kind == "local" and (self.window is None):
                return False
        return True

    def validate(self) -> None:
        assert self.d_model % self.num_heads == 0 or self.head_dim
        assert self.num_heads % self.kv_heads == 0, "GQA grouping"
        if self.num_experts:
            assert self.experts_per_token >= 1
        if "local" in self.block_unit:
            assert self.window is not None
        if self.encoder_layers:
            assert self.frontend == "audio_frames"
        if self.mrope_sections is not None:
            assert sum(self.mrope_sections) == self.head_width // 2
