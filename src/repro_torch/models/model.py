"""``LMModel``: the port of ``repro/models/model.py`` over the five
families: the decoder LMs (``dense``, ``moe``, ``ssm``, ``hybrid``,
``models.transformer``) and the encoder-decoder (``encdec``,
``models.encdec``), dispatched on ``is_encdec`` as in the reference.

``build_model(cfg)`` makes the model's weights on the card (``device=None``
means ``"cuda"``, which raises on a box without CUDA); ``device="cpu"``
runs the plain versions and ``device="meta"`` allocates nothing, for the
specs alone. The model owns its parameters under the reference's names
(``embed``, ``final_norm``, ``lm_head``, ``layers.<i>.{ln1, mixer.*, ln2,
ffn.*}``; an encoder-decoder's ``enc_norm``, ``enc_layers.<i>.*`` and
``dec_layers.<i>.*``; ``blocks.Layer``) in the reference's ``[d_in,
d_out]`` layout, so ``models.convert.load_reference`` copies the
reference's weights across.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from . import blocks, encdec, transformer
from .layers import DTYPE


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class LMModel(nn.Module):
    """A model of any family: ``forward``, ``loss``, ``prefill`` and
    ``decode_step`` (the last two under ``torch.inference_mode``), with
    ``init_caches`` and the shape-only ``input_specs`` / ``cache_specs``.
    ``n_layers`` that ``block_period`` does not divide raises
    ``ValueError``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device).manual_seed(0)
        p = self._family.init_params(cfg, generator, device)
        # the tensors first, then the lists of layers
        for name, x in sorted(p.items(), key=lambda kv: isinstance(
                kv[1], list)):
            setattr(self, name, nn.ModuleList(blocks.Layer(lp) for lp in x)
                    if isinstance(x, list) else nn.Parameter(x))

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    @property
    def _family(self):
        """The module that assembles this model: ``encdec`` or
        ``transformer``."""
        return encdec if self.is_encdec else transformer

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- train ----------------------------------------------------------------
    def forward(self, batch):
        """Full-sequence forward -> (logits [B,S,V], aux_loss)."""
        return self._family.forward(self, self.cfg, batch)

    def loss(self, batch) -> torch.Tensor:
        return self._family.loss_fn(self, self.cfg, batch)

    # -- serve ----------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        """A decoder LM: (last-token logits [B, 1, V], caches); an
        encoder-decoder: its caches alone (``max_len`` unused), as in the
        reference."""
        if self.is_encdec:
            return encdec.prefill(self, self.cfg, batch)
        return transformer.prefill(self, self.cfg, batch, max_len)

    @torch.inference_mode()
    def decode_step(self, tokens, caches, pos: int):
        return self._family.decode_step(self, self.cfg, tokens, caches, pos)

    def init_caches(self, batch: int, max_len: int) -> list:
        """One cache a layer: a ``KVCache`` of ``max_len`` positions or a
        recurrent layer's state, zeroed. An encoder-decoder's caches come
        from ``prefill`` (``ValueError``)."""
        if self.is_encdec:
            raise ValueError(f"{self.cfg.name}: encdec caches come from "
                             "prefill()")
        return transformer.init_caches(self.cfg, batch, max_len, self.device)

    # -- shape-only specs (meta tensors) --------------------------------------
    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins for every model input (no allocation).

        train  -> the train batch
        prefill-> the prompt batch (an encoder-decoder's frames)
        decode -> tokens [B,1] -- caches come from cache_specs()."""
        b, s = shape.global_batch, shape.seq_len
        cfg = self.cfg
        i32 = torch.int32
        if shape.kind not in ("train", "prefill"):
            return {"tokens": _meta((b, 1), i32)}
        if self.is_encdec:
            out = {"frames": _meta((b, s, cfg.d_model), DTYPE)}
            if shape.kind == "train":
                s_dec = max(s // 4, 16)     # text shorter than audio frames
                out["tokens"] = _meta((b, s_dec), i32)
                out["labels"] = _meta((b, s_dec), i32)
            return out
        if cfg.embed_frontend_stub:     # vlm backbone: patch embeddings
            out = {"embeds": _meta((b, s, cfg.d_model), DTYPE)}
        else:
            out = {"tokens": _meta((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = _meta((b, s), i32)
        return out

    def cache_specs(self, shape: ShapeSpec):
        """Meta-tensor decode caches: a decoder LM's one a layer (KV of
        ``seq_len`` per shape, or a recurrent state); an encoder-decoder's
        dict of stacked self caches and cross K/V of ``seq_len`` frames."""
        b, s = shape.global_batch, shape.seq_len
        cfg = self.cfg
        if self.is_encdec:
            cross = (cfg.n_layers, b, s, cfg.n_kv, cfg.head_dim)
            return {"self": encdec.init_self_caches(cfg, b, "meta"),
                    "cross_k": _meta(cross, DTYPE),
                    "cross_v": _meta(cross, DTYPE)}
        return transformer.init_caches(cfg, b, s, "meta")


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
