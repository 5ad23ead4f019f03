"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; QKV bias, tied embeddings [arXiv:2407.10671; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_1_5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
    vocab=151_936, qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2_1_5b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)
