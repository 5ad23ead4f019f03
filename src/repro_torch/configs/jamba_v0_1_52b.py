"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba+attention 1:7 interleave, MoE 16 experts top-2 on every
second layer [arXiv:2403.19887; hf]. Hybrid -> long_500k runs (attention
only on 4 of 32 layers; the sharded KV cache fits)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba_v0_1_52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14_336,
    vocab=65_536, n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=3, block_period=8,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = ArchConfig(
    name="jamba_v0_1_52b_smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=96,
    vocab=512, n_experts=4, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=3, block_period=8,
    mamba_d_state=4, mamba_d_conv=4, mamba_expand=2,
)
