"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_3_8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12_800,
    vocab=49_155,
)

SMOKE = ArchConfig(
    name="granite_3_8b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=160,
    vocab=512,
)
