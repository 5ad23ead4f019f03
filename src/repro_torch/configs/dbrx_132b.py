"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx_132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10_752,
    vocab=100_352, n_experts=16, top_k=4,
)

SMOKE = ArchConfig(
    name="dbrx_132b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96,
    vocab=512, n_experts=4, top_k=2,
)
