"""Shared layers: norms, SwiGLU MLP, embeddings, RoPE (the port of
``repro/models/layers.py``).

Weights are bfloat16 and norm scales float32, as in the reference. The
initialisers draw from an explicit ``torch.Generator`` on the target device
with the reference's distributions; the draws themselves differ from
``jax.random``'s, so only weights carried across (``models.convert``)
compare.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops

DTYPE = torch.bfloat16


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def init_rms(d: int, device) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def _init(shape, fan_in: int, generator: Optional[torch.Generator],
          device) -> torch.Tensor:
    """Normal(0, 1 / fan_in) in float32, cast to ``DTYPE``. A ``meta``
    device allocates nothing and draws nothing."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * (fan_in ** -0.5)).to(DTYPE)


def init_mlp(d: int, f: int, gelu: bool, generator, device) -> dict:
    p = {"w1": _init((d, f), d, generator, device)}
    if not gelu:
        p["w3"] = _init((d, f), d, generator, device)
    p["w2"] = _init((f, d), f, generator, device)
    return p


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    if "w3" in params:       # SwiGLU
        h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    else:                    # 2-matrix GeLU (gpt-bigcode style); jax.nn.gelu
        h = F.gelu(x @ params["w1"], approximate="tanh")   # is the tanh form
    return h @ params["w2"]


def init_embed(vocab: int, d: int, generator, device) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * 0.02).to(DTYPE)


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


@functools.lru_cache(maxsize=None)
def _device_freqs(d_head: int, theta: float, device: torch.device):
    """``rope_freqs`` as float32 on ``device``, copied there once: a copy
    from host memory a call waits for the card, twice a layer. A
    ``launch.roofline`` count does not see the one copy, so a call counts
    the same whether the cache is warm or cold."""
    with torch.inference_mode(False), kernel_ops.hidden_work():
        return torch.as_tensor(rope_freqs(d_head, theta), dtype=torch.float32,
                               device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, dh]; positions: [B, S] int. Rotates the interleaved
    pairs ``(x[..., ::2], x[..., 1::2])``, as the reference does."""
    dh = x.shape[-1]
    freqs = _device_freqs(dh, theta, x.device)
    ang = positions[..., None].float() * freqs                  # [B,S,dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32. logits [B, S, V], labels [B, S]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
