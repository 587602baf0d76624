"""whisper-tiny [audio]: enc-dec, conv frontend stubbed as precomputed
frame embeddings.  4 encoder + 4 decoder layers, d=384, 6H (kv=6),
d_ff=1536, vocab=51865.  [arXiv:2212.04356; unverified]

Deviation (DESIGN.md §8): decoder uses RoPE instead of learned absolute
positions so the 32k stress shapes are well-defined; encoder keeps
whisper's sinusoidal positions.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_kind="gelu",
    block_unit=("attn",),
    frontend="audio_frames",
    tie_embeddings=True,
    optimizer="adamw",
)
