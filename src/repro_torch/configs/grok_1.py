"""grok-1-314b [moe]: 8 experts top-2, attention logit softcap 30.
64L, d=6144, 48H (kv=8, head_dim=128), per-expert d_ff=32768,
vocab=131072.  [hf:xai-org/grok-1; unverified]

Memory policy: Adafactor training state (DESIGN.md §6).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    mlp_kind="swiglu",
    num_experts=8,
    experts_per_token=2,
    attn_logit_softcap=30.0,
    tie_embeddings=False,
    optimizer="adafactor",
)
