"""llama4-maverick-400b-a17b [moe]: MoE 128 experts top-1 (early
fusion).  48L, d=5120, 40H (kv=8, head_dim=128), per-expert d_ff=8192,
vocab=202048.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Memory policy (DESIGN.md §6): per the assigned numbers this config has
~780B parameters; training state uses momentum-free factored Adafactor
so the single-pod (256-chip) train cell fits 16 GB/chip HBM.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    mlp_kind="swiglu",
    num_experts=128,
    experts_per_token=1,
    tie_embeddings=False,
    optimizer="adafactor",
)
