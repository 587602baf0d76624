"""rwkv6-3b [ssm] "Finch": attention-free, data-dependent decay wkv +
squared-ReLU channel mix.  32L, d=2560 (40 heads x 64), d_ff=8960,
vocab=65536.  [arXiv:2404.05892; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # informational; time-mix uses rwkv_head_dim
    d_ff=8960,
    vocab_size=65_536,
    block_unit=("rwkv",),
    rwkv_head_dim=64,
    tie_embeddings=False,
    optimizer="adamw",
)
