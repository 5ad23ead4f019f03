"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064; RoPE + SwiGLU + GQA [arXiv:2412.08905; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4_mini_3_8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=200_064, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="phi4_mini_3_8b_smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=192,
    vocab=512, tie_embeddings=True,
)
