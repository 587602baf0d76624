"""yi-6b [dense]: llama-architecture GQA.  32L, d=4096, 32H (kv=4,
head_dim=128), d_ff=11008, vocab=64000.  [arXiv:2403.04652; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    mlp_kind="swiglu",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    optimizer="adamw",
)
