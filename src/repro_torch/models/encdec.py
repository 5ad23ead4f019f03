"""Encoder-decoder backbone (seamless-m4t-large-v2): the port of
``repro/models/encdec.py``.

The encoder's input is the audio frontend's stub, as in the reference:
precomputed frame embeddings [B, T, D]. Its layers run full (non-causal)
self-attention with RoPE on q and k; the decoder is a causal LM whose
layers also attend over the encoder's output. ``params`` is any module
holding ``embed``, ``final_norm``, ``enc_norm``, ``lm_head`` and the
``nn.ModuleList``s ``enc_layers`` and ``dec_layers`` of ``blocks.Layer``
(``model.LMModel``), under the reference's names: ``enc_layers.<i>.{ln1,
mixer.*, ln2, ffn.*}`` and ``dec_layers.<i>.{ln1, mixer.*, ln_x, cross.*,
ln2, ffn.*}``; a Python loop over them replaces the reference's
``lax.scan`` over the stacked ``enc_blocks`` and ``dec_blocks``.

``forward`` is the train path, plain torch for autograd. ``prefill``
encodes with each layer's self-attention through the flash attention
kernel (``attention.self_attention(..., causal=False)``, at any number of
frames), projects each decoder layer's cross K and V once, and makes empty
self-attention caches of ``SELF_BUFFER`` positions: ``{"self": KVCache
[L, B, SELF_BUFFER, K, dh], "cross_k", "cross_v": [L, B, T, K, dh]}``.
``decode_step`` clamps ``pos`` to ``SELF_BUFFER - 1`` for the cache slot
and the RoPE position, as the reference does: past the buffer each step
overwrites the last slot and attends over the whole buffer. The cross
attention of a step is plain torch over the projected K and V.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import attention as attn
from .layers import (DTYPE, cross_entropy, init_embed, init_mlp, init_rms,
                     mlp, rms_norm)

SELF_BUFFER = 1024      # decoder self-attention generation window


def init_enc_layer(cfg, generator, device) -> dict:
    return {"ln1": init_rms(cfg.d_model, device),
            "mixer": attn.init_attention(cfg, generator, device),
            "ln2": init_rms(cfg.d_model, device),
            "ffn": init_mlp(cfg.d_model, cfg.d_ff, False, generator, device)}


def init_dec_layer(cfg, generator, device) -> dict:
    return {"ln1": init_rms(cfg.d_model, device),
            "mixer": attn.init_attention(cfg, generator, device),
            "ln_x": init_rms(cfg.d_model, device),
            "cross": attn.init_attention(cfg, generator, device),
            "ln2": init_rms(cfg.d_model, device),
            "ffn": init_mlp(cfg.d_model, cfg.d_ff, False, generator, device)}


def init_params(cfg, generator, device) -> dict:
    """The reference's parameters, drawn in its order from ``generator``:
    the encoder layers, the decoder layers, ``embed``, ``lm_head``. The
    layers are lists of dicts (the reference's ``mlp`` is SwiGLU here
    whatever ``mlp_gelu`` says)."""
    enc = [init_enc_layer(cfg, generator, device)
           for _ in range(cfg.n_enc_layers)]
    dec = [init_dec_layer(cfg, generator, device)
           for _ in range(cfg.n_layers)]
    return {"embed": init_embed(cfg.vocab, cfg.d_model, generator, device),
            "final_norm": init_rms(cfg.d_model, device),
            "enc_norm": init_rms(cfg.d_model, device),
            "enc_layers": enc, "dec_layers": dec,
            "lm_head": init_embed(cfg.vocab, cfg.d_model, generator, device)}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params, cfg, frames, flash: bool = False) -> torch.Tensor:
    """frames [B, T, D] -> the encoder's output [B, T, D] in bfloat16. With
    ``flash`` each layer's self-attention runs through the flash attention
    kernel (prefill); without, plain torch (the train path)."""
    x = frames.to(DTYPE)
    b, t, _ = x.shape
    positions = _positions(b, t, x.device)
    for p in params.enc_layers:
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        if flash:
            q, k, v = attn._qkv(p.mixer, h, cfg, positions)
            h = attn.self_attention(q, k, v, cfg, causal=False) \
                @ p.mixer["wo"]
        else:
            h = attn.full_attention(p.mixer, h, cfg, positions, causal=False)
        x = x + h
        x = x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _logits(params, cfg, x) -> torch.Tensor:
    return rms_norm(x, params.final_norm, cfg.norm_eps) @ params.lm_head.T


def forward(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced train path: ``frames`` [B, T, D] and ``tokens`` [B,
    S] -> (logits [B, S, V], aux = 0)."""
    memory = encode(params, cfg, batch["frames"])
    x = params.embed[batch["tokens"].long()]
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for p in params.dec_layers:
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        x = x + attn.full_attention(p.mixer, h, cfg, positions)
        h = rms_norm(x, p.ln_x, cfg.norm_eps)
        x = x + attn.cross_attention(p.cross, h, memory, cfg)
        x = x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def loss_fn(params, cfg, batch) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_self_caches(cfg, batch: int, device) -> attn.KVCache:
    """Every decoder layer's self-attention cache, stacked: K and V [L, B,
    SELF_BUFFER, K, dh], zeroed."""
    shape = (cfg.n_layers, batch, SELF_BUFFER, cfg.n_kv, cfg.head_dim)
    return attn.KVCache(torch.zeros(shape, dtype=DTYPE, device=device),
                        torch.zeros(shape, dtype=DTYPE, device=device))


def prefill(params, cfg, batch) -> dict:
    """Encode ``frames`` (the kernel's attention), project each decoder
    layer's cross K and V, and make empty self caches -> the caches."""
    memory = encode(params, cfg, batch["frames"], flash=True)
    b, t, _ = memory.shape
    k, dh = cfg.n_kv, cfg.head_dim
    cross_k = torch.stack([(memory @ p.cross["wk"]).reshape(b, t, k, dh)
                           for p in params.dec_layers])
    cross_v = torch.stack([(memory @ p.cross["wv"]).reshape(b, t, k, dh)
                           for p in params.dec_layers])
    return {"self": init_self_caches(cfg, b, memory.device),
            "cross_k": cross_k, "cross_v": cross_v}


def decode_step(params, cfg, tokens, caches, pos: int):
    """One step: tokens [B, 1] int, pos a Python int -> (logits [B, 1, V],
    caches, the self caches written in place at ``min(pos, SELF_BUFFER -
    1)``)."""
    x = params.embed[tokens.long()]
    b = x.shape[0]
    slot = min(pos, SELF_BUFFER - 1)
    self_c = caches["self"]
    for i, p in enumerate(params.dec_layers):
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        h, _ = attn.decode_attention(
            p.mixer, h, cfg, attn.KVCache(self_c.k[i], self_c.v[i]), slot)
        x = x + h
        # cross attention against the prefill's projection of the memory
        h = rms_norm(x, p.ln_x, cfg.norm_eps)
        q = (h @ p.cross["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        probs = torch.softmax(attn._gqa_scores(
            q, caches["cross_k"][i], cfg).float(), dim=-1)
        x = x + attn._gqa_context(probs, caches["cross_v"][i], q) \
            @ p.cross["wo"]
        x = x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))
    return _logits(params, cfg, x), caches
