"""llama3.2-3b [dense]: small llama3.  28L, d=3072, 24H (kv=8,
head_dim=128), d_ff=8192, vocab=128256, rope theta 500k, tied
embeddings.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    optimizer="adamw",
)
