"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400; 2 shared + 64 routed experts, top-6, fine-grained
[arXiv:2401.06066; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_moe_16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=102_400, n_experts=64, top_k=6, n_shared_experts=2,
)

SMOKE = ArchConfig(
    name="deepseek_moe_16b_smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=48,
    vocab=512, n_experts=8, top_k=3, n_shared_experts=2,
)
