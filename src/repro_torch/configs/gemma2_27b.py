"""gemma2-27b [dense]: alternating local/global attention, logit
softcapping (attn 50, final 30), post-sublayer norms, query scale
(d_model/num_heads)^-0.5.  46L, d=4608, 32H (kv=16, head_dim=128),
d_ff=36864, vocab=256000, window=4096.  [arXiv:2408.00118; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    mlp_kind="geglu",
    block_unit=("local", "attn"),
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    query_scale=(4608 / 32) ** -0.5,
    scale_embeddings=True,
    tie_embeddings=True,
    optimizer="adamw",
)
