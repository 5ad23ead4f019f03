"""How far two exact forms of xlstm-125M drift apart at full width, on the
CPU: the reference's ``repro.models`` and the port's ``repro_torch.models``
with the same weights (``models.convert.load_reference``), one batch of
B 2 x S 64 drawn tokens.

    PYTHONPATH=src python tools/xlstm_conditioning.py [--layers 12 4]

For each depth it prints the logits' largest |value|, the largest |diff|
between the chunkwise and the recurrent mLSTM (``MLSTM_MODE``) in each
engine, the largest |diff| between the engines, and the gradients of the
loss: each leaf's largest |port - reference| over its largest |value|,
the median and the largest over the leaves. The two engines round
bfloat16 products in other places (about one ulp a layer on the same
input, ``tests/test_torch_xlstm.py``); the difference these numbers show
beyond that is what the model carries them to. CPU numbers: they say how
the function is conditioned, nothing about a device's speed.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def _np(x):
    import torch
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def measure(layers: int, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from repro import configs as rconfigs
    from repro.models import build_model as rbuild
    from repro.models import xlstm as rxl
    from repro_torch import configs
    from repro_torch.models import build_model, xlstm
    from repro_torch.models.convert import load_reference, reference_leaf

    rcfg = dataclasses.replace(rconfigs.get_config("xlstm_125m"),
                               n_layers=layers)
    ref = rbuild(rcfg)
    params = ref.init(jax.random.key(seed))
    port = build_model(dataclasses.replace(configs.get_config("xlstm_125m"),
                                           n_layers=layers), device="cpu")
    load_reference(port, params)
    tok = np.random.default_rng(seed).integers(0, rcfg.vocab, (2, 65),
                                               dtype=np.int32)
    rb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
          "labels": torch.from_numpy(tok[:, 1:].copy())}

    def ref_logits(mode):
        # a fresh function a mode: jit caches a trace by the function
        old, rxl.MLSTM_MODE = rxl.MLSTM_MODE, mode
        try:
            return _np(jax.jit(lambda p, b: ref.forward(p, b)[0])(params, rb))
        finally:
            rxl.MLSTM_MODE = old

    def port_logits(mode):
        old, xlstm.MLSTM_MODE = xlstm.MLSTM_MODE, mode
        try:
            with torch.no_grad():
                return _np(port.forward(tb)[0])
        finally:
            xlstm.MLSTM_MODE = old

    r_chk, r_rec = ref_logits("chunkwise"), ref_logits("recurrent")
    t_chk, t_rec = port_logits("chunkwise"), port_logits("recurrent")
    rgrad = jax.jit(jax.grad(ref.loss))(params, rb)
    names, leaves = zip(*port.named_parameters())
    grads = torch.autograd.grad(port.loss(tb), list(leaves))
    rel = []
    for name, g in zip(names, grads):
        want = _np(reference_leaf(rgrad, name, rcfg.block_period))
        rel.append(float(np.abs(_np(g) - want).max()
                         / max(float(np.abs(want).max()), 1e-30)))
    return {"layers": layers, "logits_max": float(np.abs(r_chk).max()),
            "reference_chunkwise_vs_recurrent":
                float(np.abs(r_chk - r_rec).max()),
            "port_chunkwise_vs_recurrent": float(np.abs(t_chk - t_rec).max()),
            "port_vs_reference": float(np.abs(t_chk - r_chk).max()),
            "gradient_rel_median": float(np.median(rel)),
            "gradient_rel_max": max(rel),
            "gradient_rel_max_leaf": names[int(np.argmax(rel))]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[12, 4],
                    help="depths to measure (multiples of the period 4)")
    args = ap.parse_args(argv)
    out = []
    for layers in args.layers:
        out.append(measure(layers))
        print(out[-1], flush=True)
    return out


if __name__ == "__main__":
    main()
