"""qwen2-vl-72b [vlm]: M-RoPE (3-section rotary: temporal/height/width),
dynamic resolution vision tower STUBBED — input_specs provides token
ids plus (B, S, 3) multimodal position ids.  80L, d=8192, 64H (kv=8,
head_dim=128), d_ff=29568, vocab=152064.  [arXiv:2409.12191; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_patches",
    tie_embeddings=False,
    optimizer="adamw",
)
