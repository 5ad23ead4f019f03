"""Carry the reference's parameters into the port.

``load_reference(model, params)`` copies the pytree that
``repro.models.transformer.init_params`` returns (leaves as numpy arrays or
anything ``np.asarray`` reads) into an ``LMModel`` of the same config. The
reference stacks its layers in groups of ``cfg.block_period`` on a leading
axis (``params["blocks"]["pos{j}"][name][g]`` is layer ``g * period +
j``); the port keeps one module a layer, in the same ``[d_in, d_out]``
layout, so each leaf is a copy. Each leaf is read as float32 and cast to the
parameter's dtype, which is exact for bfloat16 and needs no ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch


def _copy(dst: torch.Tensor, src) -> None:
    arr = np.array(src, np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"load_reference: shape {arr.shape}, want "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(dst.dtype))


@torch.no_grad()
def load_reference(model, params) -> None:
    cfg = model.cfg
    _copy(model.embed, params["embed"])
    _copy(model.final_norm, params["final_norm"])
    if not cfg.tie_embeddings:
        _copy(model.lm_head, params["lm_head"])
    period = cfg.block_period
    for i, layer in enumerate(model.layers):
        ref = params["blocks"][f"pos{i % period}"]
        g = i // period
        _copy(layer.ln1, ref["ln1"][g])
        _copy(layer.ln2, ref["ln2"][g])
        for group in ("mixer", "ffn"):
            for key, w in getattr(layer, group).items():
                _copy(w, ref[group][key][g])
