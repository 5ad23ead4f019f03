"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409]. Backbone only per the assignment: the
ViT patch embedder is a STUB (precomputed patch embeddings)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14_336,
    vocab=131_072, d_head=160, rope_theta=1e6, embed_frontend_stub=True,
)

SMOKE = ArchConfig(
    name="pixtral_12b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160,
    vocab=512, d_head=20, rope_theta=1e6, embed_frontend_stub=True,
)
