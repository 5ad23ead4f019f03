"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks [arXiv:2405.04517]. mLSTM everywhere except every 4th block (sLSTM),
matching the paper's mostly-mLSTM ratios. Recurrent state -> long_500k runs.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm_125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0,
    vocab=50_304, slstm_every=4, slstm_offset=3, mamba_expand=2,
    block_period=4, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="xlstm_125m_smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv=2, d_ff=0,
    vocab=512, slstm_every=4, slstm_offset=3, mamba_expand=2,
    block_period=4, tie_embeddings=True,
)
