"""Architecture configs and input shapes for the assigned pool: a copy of
the reference's ``repro/configs/base.py``, field for field.

Each assigned architecture gets a module in repro_torch/configs/<id>.py exporting
``CONFIG`` (full published size) and ``SMOKE`` (reduced same-family config
for CPU smoke tests). Shapes follow the assignment:

    train_4k     seq 4096,    global_batch 256   (train_step)
    prefill_32k  seq 32768,   global_batch 32    (prefill)
    decode_32k   KV 32768,    global_batch 128   (decode_step)
    long_500k    KV 524288,   global_batch 1     (decode_step; sub-quadratic
                                                  archs only)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

ARCH_IDS = (
    "seamless_m4t_large_v2",
    "qwen2_1_5b",
    "phi4_mini_3_8b",
    "granite_3_8b",
    "granite_34b",
    "pixtral_12b",
    "dbrx_132b",
    "deepseek_moe_16b",
    "xlstm_125m",
    "jamba_v0_1_52b",
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    # attention details
    d_head: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                # qwen2
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    mlp_gelu: bool = False                # 2-matrix GeLU MLP (granite-34b)
                                          # instead of 3-matrix SwiGLU

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1                    # MoE on layers where i % moe_every
                                          # == moe_offset (jamba: every 2nd)
    moe_offset: int = 0

    # hybrid (jamba): attention on layers where i % attn_every == attn_offset,
    # Mamba elsewhere. attn_every=1 -> pure attention stack.
    attn_every: int = 1
    attn_offset: int = 0

    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xlstm: sLSTM on layers where i % slstm_every == slstm_offset
    slstm_every: int = 0                  # 0 -> no sLSTM layers
    slstm_offset: int = 3

    # enc-dec
    n_enc_layers: int = 0                 # 0 -> decoder-only

    # layer grouping for scan-over-layers (must divide n_layers and be a
    # multiple of every block pattern period)
    block_period: int = 1

    # modality frontend stub: inputs are precomputed embeddings, not tokens
    embed_frontend_stub: bool = False

    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can serve a 500k context (SSM / hybrid with sparse attention)."""
        return self.family in ("ssm", "hybrid")

    def is_attn_layer(self, i: int) -> bool:
        return i % self.attn_every == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i % self.moe_every == self.moe_offset

    def is_slstm_layer(self, i: int) -> bool:
        return self.slstm_every > 0 and i % self.slstm_every == self.slstm_offset

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6*N*D)."""
        d, dh = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            if self.family == "ssm" and not self.is_slstm_layer(i):
                di = self.mamba_expand * d   # mLSTM-ish projections
                total += d * di * 4 + di * d
            elif self.family == "ssm":
                total += d * d * 4
            elif self.family == "hybrid" and not self.is_attn_layer(i):
                di = self.mamba_expand * d
                total += 2 * d * di + di * (2 * self.mamba_d_state + 2) + di * d
            else:
                total += d * (self.n_heads * dh) * 2          # q, o
                total += d * (self.n_kv * dh) * 2             # k, v
            # ffn / moe
            ffn_mats = 2 if self.mlp_gelu else 3
            if self.is_moe_layer(i):
                e = self.n_experts + self.n_shared_experts
                total += e * ffn_mats * d * self.d_ff + d * self.n_experts
            elif self.d_ff > 0 and not (self.family == "ssm"):
                total += ffn_mats * d * self.d_ff
        if self.n_enc_layers:
            total += self.n_enc_layers * (4 * d * d + 3 * d * self.d_ff)
            total += self.n_layers * 4 * d * d                # cross attention
        return total

    def active_param_count(self) -> int:
        """MoE: only routed-active experts count toward step FLOPs."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        inactive = 0
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                inactive += (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE if smoke else mod.CONFIG


def applicable_shapes(cfg: ArchConfig) -> Tuple[str, ...]:
    """long_500k is skipped for pure full-attention archs (DESIGN.md
    §Arch-applicability); every other cell runs."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return tuple(shapes)
