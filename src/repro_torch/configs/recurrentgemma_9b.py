"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern
(two recurrent blocks per local-attention block).  38L, d=4096, 16H
(MQA kv=1, head_dim=256), d_ff=12288, vocab=256000, window=2048.
[arXiv:2402.19427; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    mlp_kind="geglu",
    block_unit=("rglru", "rglru", "local"),
    window=2048,
    scale_embeddings=True,
    tie_embeddings=True,
    optimizer="adamw",
)
