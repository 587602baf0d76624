"""gemma-7b [dense]: GeGLU, head_dim=256 (wider than d_model/heads),
16H (kv=16 — MHA on 7b; MQA is the 2b variant), 28L, d=3072,
d_ff=24576, vocab=256000, scaled embeddings.  [arXiv:2403.08295; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    mlp_kind="geglu",
    scale_embeddings=True,
    tie_embeddings=True,
    optimizer="adamw",
)
