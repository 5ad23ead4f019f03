"""``LMModel``: the port of ``repro/models/model.py`` for the decoder LMs
of the ``dense``, ``moe`` and ``hybrid`` families.

``build_model(cfg)`` makes the model's weights on the card (``device=None``
means ``"cuda"``, which raises on a box without CUDA); ``device="cpu"``
runs the plain versions and ``device="meta"`` allocates nothing, for the
specs alone. The model owns its parameters under the reference's names
(``embed``, ``final_norm``, ``lm_head``, ``layers.<i>.{ln1, mixer.*, ln2,
ffn.*}``, ``blocks.Layer``) in the reference's ``[d_in, d_out]`` layout, so
``models.convert.load_reference`` copies the reference's weights across.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from . import blocks, transformer
from .layers import DTYPE

# the families this port builds
PORTED = ("dense", "moe", "hybrid")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class LMModel(nn.Module):
    """A decoder LM: ``forward``, ``loss``, ``prefill`` and ``decode_step``
    (the last two under ``torch.inference_mode``), with ``init_caches``
    and the shape-only ``input_specs`` / ``cache_specs``. A family outside
    ``PORTED`` raises ``NotImplementedError``; ``n_layers`` that
    ``block_period`` does not divide raises ``ValueError``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in PORTED:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(ROADMAP Queue A item {blocks.LATER[cfg.family]})")
        self.cfg = cfg
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        p = transformer.init_params(cfg, generator, device)
        self.embed = nn.Parameter(p["embed"])
        self.final_norm = nn.Parameter(p["final_norm"])
        if "lm_head" in p:
            self.lm_head = nn.Parameter(p["lm_head"])
        self.layers = nn.ModuleList(blocks.Layer(lp) for lp in p["layers"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- train ----------------------------------------------------------------
    def forward(self, batch):
        """Full-sequence forward -> (logits [B,S,V], aux_loss)."""
        return transformer.forward(self, self.cfg, batch)

    def loss(self, batch) -> torch.Tensor:
        return transformer.loss_fn(self, self.cfg, batch)

    # -- serve ----------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        return transformer.prefill(self, self.cfg, batch, max_len)

    @torch.inference_mode()
    def decode_step(self, tokens, caches, pos: int):
        return transformer.decode_step(self, self.cfg, tokens, caches, pos)

    def init_caches(self, batch: int, max_len: int) -> list:
        """One cache a layer: a ``KVCache`` of ``max_len`` positions or a
        ``MambaState``, zeroed."""
        return transformer.init_caches(self.cfg, batch, max_len, self.device)

    # -- shape-only specs (meta tensors) --------------------------------------
    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins for every model input (no allocation).

        train  -> the train batch
        prefill-> the prompt batch
        decode -> tokens [B,1] -- caches come from cache_specs()."""
        b, s = shape.global_batch, shape.seq_len
        cfg = self.cfg
        i32 = torch.int32
        if shape.kind not in ("train", "prefill"):
            return {"tokens": _meta((b, 1), i32)}
        if cfg.embed_frontend_stub:     # vlm backbone: patch embeddings
            out = {"embeds": _meta((b, s, cfg.d_model), DTYPE)}
        else:
            out = {"tokens": _meta((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = _meta((b, s), i32)
        return out

    def cache_specs(self, shape: ShapeSpec) -> list:
        """Meta-tensor decode caches (KV of ``seq_len`` per shape, or a
        ``MambaState``), one a layer."""
        return transformer.init_caches(self.cfg, shape.global_batch,
                                       shape.seq_len, "meta")


def build_model(cfg: ArchConfig, device=None,
                generator: Optional[torch.Generator] = None) -> LMModel:
    """The model of ``cfg`` with fresh weights from ``generator`` (a
    generator on ``device`` seeded 0 when None)."""
    return LMModel(cfg, device, generator)


def synthetic_batch(model: LMModel, shape: ShapeSpec, seed: int = 0):
    """Concrete random batch matching input_specs, on the model's device:
    the reference's arrays, drawn in its order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in model.input_specs(shape).items():
        if spec.dtype == torch.int32:
            arr = rng.integers(0, model.cfg.vocab, spec.shape, dtype=np.int32)
        else:
            arr = rng.normal(0, 1, spec.shape).astype(np.float32)
        out[name] = torch.from_numpy(arr).to(model.device, spec.dtype)
    return out
