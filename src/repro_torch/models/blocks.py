"""Layer blocks: the port of ``repro/models/blocks.py`` for the dense
decoder (the ``attn`` mixer and the ``mlp`` channel).

``layer_kind`` is whole; a layer of another kind (``mamba``, ``mlstm``,
``slstm``, ``moe``) raises ``NotImplementedError`` naming the ROADMAP
item that ports it (``LATER``). A layer's parameters live in a ``Layer``
module under the reference's names (``ln1``, ``mixer.{wq,wk,wv,wo,b_q,
b_k,b_v}``, ``ln2``, ``ffn.{w1,w2,w3}``), in the reference's ``[d_in,
d_out]`` layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from . import attention as attn
from .layers import init_mlp, init_rms, mlp, rms_norm

# the ROADMAP item (Queue A) that ports each layer kind and model family
# this slice leaves out
LATER = {"mamba": "7d (SSM and hybrid)", "mlstm": "7d (SSM and hybrid)",
         "slstm": "7d (SSM and hybrid)", "ssm": "7d (SSM and hybrid)",
         "hybrid": "7d (SSM and hybrid)", "moe": "7c (MoE)",
         "encdec": "7e (encoder-decoder)"}


def layer_kind(cfg, i: int) -> Tuple[str, str]:
    """(mixer, channel) for layer i."""
    if cfg.family == "ssm":
        mixer = "slstm" if cfg.is_slstm_layer(i) else "mlstm"
        channel = "none" if cfg.d_ff == 0 else "mlp"
        return mixer, channel
    if cfg.family == "hybrid":
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
    else:
        mixer = "attn"
    channel = "moe" if cfg.is_moe_layer(i) else "mlp"
    return mixer, channel


def _check_kind(cfg, i: int) -> None:
    """Raises ``NotImplementedError`` unless layer i is ``(attn, mlp)``."""
    for kind in layer_kind(cfg, i):
        if kind in LATER:
            raise NotImplementedError(
                f"{cfg.name} layer {i}: the {kind!r} kind is not ported yet "
                f"(ROADMAP Queue A item {LATER[kind]})")


class Layer(nn.Module):
    """One block's parameters: ``ln1``, ``mixer``, ``ln2`` and ``ffn``."""

    def __init__(self, params: dict):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"])
        self.mixer = nn.ParameterDict(params["mixer"])
        self.ln2 = nn.Parameter(params["ln2"])
        self.ffn = nn.ParameterDict(params["ffn"])


def init_layer(cfg, i: int, generator, device) -> dict:
    _check_kind(cfg, i)
    return {"ln1": init_rms(cfg.d_model, device),
            "mixer": attn.init_attention(cfg, generator, device),
            "ln2": init_rms(cfg.d_model, device),
            "ffn": init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gelu, generator,
                            device)}


def init_layer_cache(cfg, i: int, batch: int, max_len: int, device):
    _check_kind(cfg, i)
    return attn.init_kv_cache(cfg, batch, max_len, device)


# -- forward paths -----------------------------------------------------------

def _channel(p, x, cfg):
    return x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))


def apply_train(p, x, cfg, i: int, positions):
    """Full-sequence path (train / logits-over-sequence) -> (x, aux)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attn.full_attention(p.mixer, h, cfg, positions)
    return _channel(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def apply_prefill(p, x, cfg, i: int, positions, max_len: int):
    """Full-sequence forward that also fills the layer's decode cache
    (``max_len`` positions, the prompt's at the front) -> (x, aux, cache).
    The attention runs through the flash attention kernel."""
    b, s, _ = x.shape
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    q, k, v = attn._qkv(p.mixer, h, cfg, positions)
    cache = attn.init_kv_cache(cfg, b, max_len, x.device)
    cache.k[:, :s] = k
    cache.v[:, :s] = v
    x = x + attn.causal_self_attention(q, k, v, cfg) @ p.mixer["wo"]
    return _channel(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                             device=x.device), cache


def apply_decode(p, x, cfg, i: int, cache, pos: int):
    """One-token step against the layer cache, written in place."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    h, cache = attn.decode_attention(p.mixer, h, cfg, cache, pos)
    return _channel(p, x + h, cfg), cache
