"""Layer blocks: the port of ``repro/models/blocks.py`` for the decoder's
``attn`` and ``mamba`` mixers and its ``mlp`` and ``moe`` channels.

``layer_kind`` is whole; a layer of another kind (``mlstm``, ``slstm``)
raises ``NotImplementedError`` naming the ROADMAP item that ports it
(``LATER``). A layer's parameters live in a ``Layer`` module under the
reference's names (``ln1``, ``mixer.{wq,wk,wv,wo,b_q,b_k,b_v}`` or
``mixer.{in_proj,conv_w,...}``, ``ln2``, ``ffn.{w1,w2,w3}`` or
``ffn.{router,experts_w1,...}``), in the reference's ``[d_in, d_out]``
layout. A layer's cache is a ``KVCache`` (attention) or a ``MambaState``.

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
from .layers import init_mlp, init_rms, mlp, rms_norm

# the ROADMAP item (Queue A) that ports each layer kind and model family
# still left out
LATER = {"mlstm": "3 (xLSTM)", "slstm": "3 (xLSTM)", "ssm": "3 (xLSTM)",
         "encdec": "4 (encoder-decoder)"}


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
    """Raises ``NotImplementedError`` for a kind this port leaves out."""
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
    mixer, channel = layer_kind(cfg, i)
    return {"ln1": init_rms(cfg.d_model, device),
            "mixer": (attn.init_attention(cfg, generator, device)
                      if mixer == "attn"
                      else mb.init_mamba(cfg, generator, device)),
            "ln2": init_rms(cfg.d_model, device),
            "ffn": (moe_mod.init_moe(cfg, generator, device)
                    if channel == "moe"
                    else init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gelu,
                                  generator, device))}


def init_layer_cache(cfg, i: int, batch: int, max_len: int, device):
    _check_kind(cfg, i)
    if layer_kind(cfg, i)[0] == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, device)
    return mb.init_mamba_state(cfg, batch, device)


# -- forward paths -----------------------------------------------------------

def _channel(p, x, cfg, i: int):
    """The channel mixer's residual -> (x, the MoE's aux loss, or None for
    an MLP, so that no caller makes a zero it then adds or drops)."""
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if layer_kind(cfg, i)[1] == "moe":
        h, aux = moe_mod.moe_ffn(p.ffn, h, cfg)
        return x + h, aux
    return x + mlp(p.ffn, h), None


def apply_train(p, x, cfg, i: int, positions):
    """Full-sequence path (train / logits-over-sequence) -> (x, aux), aux
    None for an MLP layer."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if layer_kind(cfg, i)[0] == "attn":
        h = attn.full_attention(p.mixer, h, cfg, positions)
    else:
        h = mb.mamba_forward(p.mixer, h, cfg)
    return _channel(p, x + h, cfg, i)


def apply_prefill(p, x, cfg, i: int, positions, max_len: int):
    """Full-sequence forward that also fills the layer's decode cache ->
    (x, aux, cache), aux None for an MLP layer. An attention layer's cache
    holds ``max_len`` positions, the prompt's at the front, and its
    attention runs through the flash attention kernel; a Mamba layer's is
    its ``MambaState`` after the prompt."""
    b, s, _ = x.shape
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if layer_kind(cfg, i)[0] == "attn":
        q, k, v = attn._qkv(p.mixer, h, cfg, positions)
        cache = attn.init_kv_cache(cfg, b, max_len, x.device)
        cache.k[:, :s] = k
        cache.v[:, :s] = v
        h = attn.causal_self_attention(q, k, v, cfg) @ p.mixer["wo"]
    else:
        h, cache = _mamba_prefill(p.mixer, h, cfg)
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
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if layer_kind(cfg, i)[0] == "attn":
        h, cache = attn.decode_attention(p.mixer, h, cfg, cache, pos)
    else:
        h, cache = mb.mamba_decode(p.mixer, h, cfg, cache)
    return _channel(p, x + h, cfg, i)[0], cache
