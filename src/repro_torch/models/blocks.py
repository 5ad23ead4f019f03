"""Layer blocks: the port of ``repro/models/blocks.py``, one interface over
the ``attn``, ``mamba``, ``mlstm`` and ``slstm`` token mixers and the
``mlp``, ``moe`` and ``none`` channels.

A layer's parameters live in a ``Layer`` module under the reference's names
(``ln1``, ``mixer.{wq,wk,wv,wo,b_q,b_k,b_v}``, ``mixer.{in_proj,conv_w,
...}``, ``mixer.{up_proj,wq,...,gate_i,gate_f,down_proj}`` or
``mixer.{wx,rh,bias}``, then ``ln2`` and ``ffn.{w1,w2,w3}`` or
``ffn.{router,experts_w1,...}``), in the reference's ``[d_in, d_out]``
layout. A layer of the ``none`` channel (xLSTM with ``d_ff = 0``) has no
``ln2``, no ``ffn`` and no channel residual, as in the reference. A
layer's cache is a ``KVCache`` (attention), a ``MambaState``, an
``MLSTMState`` or an ``SLSTMState``.

The reference's prefill reruns the whole scan (``_mamba_tail_state``) for
the final ssm state; the port keeps the final state of the forward's own
loop, the same recurrence on the same inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import nn

from . import attention as attn
from . import mamba as mb
from . import moe as moe_mod
from . import xlstm as xl
from .layers import init_mlp, init_rms, mlp, rms_norm


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


class Layer(nn.Module):
    """One block's parameters under the reference's names: each tensor of
    ``params`` a parameter, each dict (``mixer``, ``ffn``, an encoder-
    decoder's ``cross``) a ``ParameterDict``."""

    def __init__(self, params: dict):
        super().__init__()
        for name, p in params.items():
            setattr(self, name, nn.ParameterDict(p) if isinstance(p, dict)
                    else nn.Parameter(p))


_INIT_MIXER = {"attn": attn.init_attention, "mamba": mb.init_mamba,
               "mlstm": xl.init_mlstm, "slstm": xl.init_slstm}


def init_layer(cfg, i: int, generator, device) -> dict:
    mixer, channel = layer_kind(cfg, i)
    p = {"ln1": init_rms(cfg.d_model, device),
         "mixer": _INIT_MIXER[mixer](cfg, generator, device)}
    if channel != "none":
        p["ln2"] = init_rms(cfg.d_model, device)
        p["ffn"] = (moe_mod.init_moe(cfg, generator, device)
                    if channel == "moe"
                    else init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gelu,
                                  generator, device))
    return p


def init_layer_cache(cfg, i: int, batch: int, max_len: int, device):
    mixer = layer_kind(cfg, i)[0]
    if mixer == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, device)
    if mixer == "mamba":
        return mb.init_mamba_state(cfg, batch, device)
    if mixer == "mlstm":
        return xl.init_mlstm_state(cfg, batch, device)
    return xl.init_slstm_state(cfg, batch, device)


# -- forward paths -----------------------------------------------------------

def _channel(p, x, cfg, i: int):
    """The channel mixer's residual -> (x, the MoE's aux loss, or None for
    an MLP or no channel, so that no caller makes a zero it then adds or
    drops)."""
    channel = layer_kind(cfg, i)[1]
    if channel == "none":
        return x, None
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if channel == "moe":
        h, aux = moe_mod.moe_ffn(p.ffn, h, cfg)
        return x + h, aux
    return x + mlp(p.ffn, h), None


def apply_train(p, x, cfg, i: int, positions):
    """Full-sequence path (train / logits-over-sequence) -> (x, aux), aux
    None for a layer without MoE."""
    mixer = layer_kind(cfg, i)[0]
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if mixer == "attn":
        h = attn.full_attention(p.mixer, h, cfg, positions)
    elif mixer == "mamba":
        h = mb.mamba_forward(p.mixer, h, cfg)
    elif mixer == "mlstm":
        h = xl.mlstm_forward(p.mixer, h, cfg)
    else:
        h = xl.slstm_forward(p.mixer, h, cfg)
    return _channel(p, x + h, cfg, i)


def apply_prefill(p, x, cfg, i: int, positions, max_len: int):
    """Full-sequence forward that also fills the layer's decode cache ->
    (x, aux, cache), aux None for a layer without MoE. An attention
    layer's cache holds ``max_len`` positions, the prompt's at the front,
    and its attention runs through the flash attention kernel; a recurrent
    layer's is its state after the prompt."""
    b, s, _ = x.shape
    mixer = layer_kind(cfg, i)[0]
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if mixer == "attn":
        q, k, v = attn._qkv(p.mixer, h, cfg, positions)
        cache = attn.init_kv_cache(cfg, b, max_len, x.device)
        cache.k[:, :s] = k
        cache.v[:, :s] = v
        h = attn.self_attention(q, k, v, cfg) @ p.mixer["wo"]
    elif mixer == "mamba":
        h, cache = _mamba_prefill(p.mixer, h, cfg)
    elif mixer == "mlstm":
        h, cache = xl.mlstm_forward(p.mixer, h, cfg,
                                    xl.init_mlstm_state(cfg, b, x.device))
    else:
        h, cache = xl.slstm_forward(p.mixer, h, cfg,
                                    xl.init_slstm_state(cfg, b, x.device))
    x, aux = _channel(p, x + h, cfg, i)
    return x, aux, cache


def _mamba_prefill(params, x, cfg):
    """mamba_forward + final (conv window, ssm state) for decode handoff:
    the window is the last (d_conv - 1) pre-conv activations, zero rows
    before the prompt as the forward's conv pads them."""
    out, xr, h = mb._scan(params, x, cfg)
    kw = cfg.mamba_d_conv
    window = F.pad(xr, (0, 0, kw - 1, 0))[:, -(kw - 1):, :]
    return out, mb.MambaState(window, h)


def apply_decode(p, x, cfg, i: int, cache, pos: int):
    """One-token step against the layer cache (an attention layer's is
    written in place); the MoE's aux is dropped."""
    mixer = layer_kind(cfg, i)[0]
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if mixer == "attn":
        h, cache = attn.decode_attention(p.mixer, h, cfg, cache, pos)
    elif mixer == "mamba":
        h, cache = mb.mamba_decode(p.mixer, h, cfg, cache)
    elif mixer == "mlstm":
        h, cache = xl.mlstm_decode(p.mixer, h, cfg, cache)
    else:
        h, cache = xl.slstm_decode(p.mixer, h, cfg, cache)
    return _channel(p, x + h, cfg, i)[0], cache
