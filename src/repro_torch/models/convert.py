"""Carry the reference's parameters, and a whole training state, into the
port.

``load_reference(model, params)`` copies the pytree that
``repro.models.transformer.init_params`` or ``repro.models.encdec
.init_params`` returns (leaves as numpy arrays or anything ``np.asarray``
reads) into an ``LMModel`` of the same config. A decoder LM's reference
stacks its layers in groups of ``cfg.block_period`` on a leading axis
(``params["blocks"]["pos{j}"][name][g]`` is layer ``g * period + j``); an
encoder-decoder's stacks one layer a row (``params["enc_blocks"][name][i]``
is ``enc_layers.<i>``, ``dec_blocks`` likewise). The port keeps one module
a layer, in the same ``[d_in, d_out]`` layout, so each leaf is a copy
(``reference_leaf`` finds the reference's leaf of a port parameter name).
Each leaf is read as float32 and cast to the parameter's dtype, which is
exact for bfloat16 and needs no ``ml_dtypes``.

``train_state_from_reference(model, state)`` carries a reference
``TrainState`` across: its params into the model, its AdamW ``m`` and ``v``
as float32 and its ``step``, all on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.optimizer import AdamWState
from ..train.train_step import TrainState, train_state_init


def reference_leaf(params, name: str, period: int):
    """The reference's leaf (a pytree of ``params``' structure) of the port
    parameter ``name`` (``embed``, ``layers.<i>.mixer.wq``,
    ``dec_layers.<i>.cross.wk``, ...)."""
    parts = name.split(".")
    if parts[0] == "layers":
        i = int(parts[1])
        node, row = params["blocks"][f"pos{i % period}"], i // period
    elif parts[0] in ("enc_layers", "dec_layers"):
        node, row = params[parts[0][:3] + "_blocks"], int(parts[1])
    else:
        return params[name]
    for key in parts[2:]:
        node = node[key]
    return node[row]


def _copy(dst: torch.Tensor, src) -> None:
    arr = np.array(src, np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"load_reference: shape {arr.shape}, want "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr).to(dst.dtype))


@torch.no_grad()
def load_reference(model, params) -> None:
    period = model.cfg.block_period
    for name, p in model.named_parameters():
        _copy(p, reference_leaf(params, name, period))


def train_state_from_reference(model, state) -> TrainState:
    """The port's ``TrainState`` of the reference's ``state`` (a
    ``repro.train.TrainState``), with ``model`` holding its params."""
    load_reference(model, state.params)
    params = train_state_init(model).params
    period = model.cfg.block_period

    def moments(tree):
        out = {}
        for name, p in params.items():
            out[name] = torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
            _copy(out[name], reference_leaf(tree, name, period))
        return out

    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32,
                        device=model.device)
    return TrainState(params, AdamWState(step, moments(state.opt.m),
                                         moments(state.opt.v)))
