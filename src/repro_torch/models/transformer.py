"""Decoder LM assembly: embeddings, the blocks, the head; the port of
``repro/models/transformer.py``.

A Python loop over the layers of ``params.layers`` (an ``nn.ModuleList``
of ``blocks.Layer``) replaces the reference's ``lax.scan`` over stacked
groups. ``params`` is any module holding ``embed``, ``final_norm``,
``layers`` and, without tied embeddings, ``lm_head`` (``model.LMModel``).
The caches are a list of one cache a layer, a ``KVCache`` (written in
place) or a ``MambaState`` by the layer's kind, returned; ``pos`` is a
Python int.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import blocks
from .layers import DTYPE, cross_entropy, init_embed, init_rms, rms_norm


def n_groups(cfg) -> int:
    """The reference's groups of ``block_period`` layers; raises
    ``ValueError`` unless the period divides ``n_layers``."""
    if cfg.n_layers % cfg.block_period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of block_period {cfg.block_period}")
    return cfg.n_layers // cfg.block_period


def init_params(cfg, generator, device) -> dict:
    """The reference's parameters, drawn in order from ``generator``:
    the layers, then ``embed``, then ``lm_head``. ``layers`` is a list of
    ``blocks.init_layer`` dicts."""
    n_groups(cfg)
    layers = [blocks.init_layer(cfg, i, generator, device)
              for i in range(cfg.n_layers)]
    p = {"embed": init_embed(cfg.vocab, cfg.d_model, generator, device),
         "final_norm": init_rms(cfg.d_model, device),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embed(cfg.vocab, cfg.d_model, generator, device)
    return p


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_in(params, cfg, batch) -> torch.Tensor:
    """tokens or (frontend stub) precomputed embeddings -> [B, S, D]."""
    if cfg.embed_frontend_stub and "embeds" in batch:
        return batch["embeds"].to(DTYPE)
    return params.embed[batch["tokens"].long()]


def _logits(params, cfg, x) -> torch.Tensor:
    head = params.embed if cfg.tie_embeddings else params.lm_head
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ head.T


def forward(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits [B,S,V], aux_loss)."""
    x = _embed_in(params, cfg, batch)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        x, a = blocks.apply_train(layer, x, cfg, i, positions)
        if a is not None:
            aux = aux + a
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg, batch) -> torch.Tensor:
    return loss_of(*forward(params, cfg, batch), batch)


def loss_of(logits, aux, batch) -> torch.Tensor:
    """The loss of ``forward``'s (logits, aux) against ``batch``'s labels."""
    return cross_entropy(logits, batch["labels"], batch.get("mask")) \
        + 0.01 * aux


def init_caches(cfg, batch: int, max_len: int, device) -> list:
    return [blocks.init_layer_cache(cfg, i, batch, max_len, device)
            for i in range(cfg.n_layers)]


def prefill(params, cfg, batch, max_len: Optional[int] = None):
    """Run the prompt, return (last-token logits [B,1,V], caches)."""
    x = _embed_in(params, cfg, batch)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    caches = []
    for i, layer in enumerate(params.layers):
        # the reference's prefill sums the aux and drops the sum
        x, _, cache = blocks.apply_prefill(layer, x, cfg, i, positions,
                                           max_len)
        caches.append(cache)
    return _logits(params, cfg, x[:, -1:, :]), caches


def decode_step(params, cfg, tokens, caches, pos: int):
    """One decode step: tokens [B, 1] int, pos a Python int ->
    (logits [B,1,V], caches)."""
    x = params.embed[tokens.long()]
    for i, layer in enumerate(params.layers):
        x, caches[i] = blocks.apply_decode(layer, x, cfg, i, caches[i], pos)
    return _logits(params, cfg, x), caches
