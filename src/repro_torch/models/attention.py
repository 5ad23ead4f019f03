"""GQA attention: train (full, causal or not), prefill (the port's flash
attention kernel), decode (KV cache) and the decoder's cross attention; the
port of ``repro/models/attention.py``.

``full_attention`` and ``cross_attention`` stay plain torch, computed as
the reference computes them (Q reshaped to ``[B, S, K, H/K, dh]``, the KV
heads never repeated): the train path needs autograd, and cross attention's
S queries against T memory rows are a shape the kernel does not take.
Prefill's self-attention, causal in a decoder and full in the
encoder-decoder's encoder, is the reference's softmax attention, which is
the plain version of ``kernels.flash_attention`` once the KV heads are
expanded to the query heads by ``repeat_interleave``; it runs through
``kernels.ops.flash_attention``, so on the card it launches the attention
kernel. The kernel is called at the sequence's own length S, whatever it
is: it masks the keys past S itself, so no padded key weighs in, with or
without the causal mask, and no ragged call falls back to the plain
version. Decode attends over the cache up to ``pos`` in plain torch: no
TPU kernel computes it in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from .layers import DTYPE, _init, apply_rope

def init_attention(cfg, generator, device) -> dict:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": _init((d, h * dh), d, generator, device),
         "wk": _init((d, k * dh), d, generator, device),
         "wv": _init((d, k * dh), d, generator, device),
         "wo": _init((h * dh, d), h * dh, generator, device)}
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((h * dh,), dtype=DTYPE, device=device)
        p["b_k"] = torch.zeros((k * dh,), dtype=DTYPE, device=device)
        p["b_v"] = torch.zeros((k * dh,), dtype=DTYPE, device=device)
    return p


def _qkv(params, x, cfg, positions, rope: bool = True):
    b, s, _ = x.shape
    h, k, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ params["wq"]
    kk = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, kk, v = q + params["b_q"], kk + params["b_k"], v + params["b_v"]
    q = q.reshape(b, s, h, dh)
    kk = kk.reshape(b, s, k, dh)
    v = v.reshape(b, s, k, dh)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _gqa_scores(q, k, cfg):
    """q [B,S,H,dh], k [B,T,K,dh] -> scores [B,K,H/K,S,T] without repeat."""
    b, s, h, dh = q.shape
    g = h // cfg.n_kv
    qg = q.reshape(b, s, cfg.n_kv, g, dh)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) * (dh ** -0.5)


def _gqa_context(probs, v, q):
    """probs [B,K,G,S,T] (float32) cast to q's dtype, @ v [B,T,K,dh] ->
    [B, S, H * dh]."""
    ctx = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v)
    return ctx.reshape(q.shape[0], q.shape[1], -1)


def full_attention(params, x, cfg, positions, causal: bool = True):
    """Train path (plain torch)."""
    s = x.shape[1]
    q, k, v = _qkv(params, x, cfg, positions)
    scores = _gqa_scores(q, k, cfg).float()
    if causal:
        above = torch.ones((s, s), dtype=torch.bool,
                           device=x.device).triu(1)
        scores = scores.masked_fill(above, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_context(probs, v, q) @ params["wo"]


def cross_attention(params, x, memory, cfg):
    """The decoder's attention over the encoder's output ``memory`` [B, T,
    D] (no causal mask, no RoPE): x [B, S, D] -> [B, S, D], plain torch."""
    b, s, _ = x.shape
    t = memory.shape[1]
    h, kn, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (memory @ params["wk"]).reshape(b, t, kn, dh)
    v = (memory @ params["wv"]).reshape(b, t, kn, dh)
    probs = torch.softmax(_gqa_scores(q, k, cfg).float(), dim=-1)
    return _gqa_context(probs, v, q) @ params["wo"]


def self_attention(q, k, v, cfg, causal: bool = True):
    """Prefill's self-attention through ``ops.flash_attention``: q [B, S,
    H, dh], k and v [B, S, K, dh] -> [B, S, H * dh], at any S. The KV
    heads are expanded to the query heads by ``repeat_interleave`` (query
    head j reads KV head j // (H/K), as the reference's reshape does) in
    ``[B, H, S, dh]`` layout."""
    b, s, h, dh = q.shape
    g = h // cfg.n_kv
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    out = ops.flash_attention(qh, kh, vh, causal=causal)
    return out.transpose(1, 2).reshape(b, s, h * dh)


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_max, K, dh]
    v: torch.Tensor


def init_kv_cache(cfg, batch: int, max_len: int, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=DTYPE, device=device),
                   torch.zeros(shape, dtype=DTYPE, device=device))


def decode_attention(params, x, cfg, cache: KVCache, pos: int):
    """One-token decode: write the cache at ``pos`` in place, attend over
    positions ``0..pos``. x: [B, 1, D]; pos: a Python int. The reference
    attends over the whole cache with the mask ``arange(S_max) <= pos``;
    the masked positions weigh exactly 0 there, so the slice gives the same
    softmax."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg,
                           torch.full((b, 1), pos, dtype=torch.int32,
                                      device=x.device))
    cache.k[:, pos:pos + 1] = k_new
    cache.v[:, pos:pos + 1] = v_new
    k, v = cache.k[:, :pos + 1], cache.v[:, :pos + 1]
    scores = _gqa_scores(q, k, cfg).float()                 # [B,K,G,1,T]
    probs = torch.softmax(scores, dim=-1)
    return _gqa_context(probs, v, q) @ params["wo"], cache
