"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch code model [arXiv:2405.04324; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_ff=24_576,
    vocab=49_152, mlp_gelu=True,    # gpt-bigcode-style 2-matrix MLP
)

SMOKE = ArchConfig(
    name="granite_34b_smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=256,
    vocab=512, mlp_gelu=True,
)
