"""seamless-m4t-large-v2 [audio]: enc-dec multimodal backbone.

24 encoder + 24 decoder layers, d_model 1024, 16H (kv=16), d_ff 8192,
vocab 256206 [arXiv:2308.11596; hf]. The speech frontend is a STUB per the
assignment: input_specs provides precomputed frame embeddings.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_large_v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
    vocab=256_206, n_enc_layers=24, embed_frontend_stub=True,
)

SMOKE = ArchConfig(
    name="seamless_m4t_large_v2_smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, n_enc_layers=2, embed_frontend_stub=True,
)
