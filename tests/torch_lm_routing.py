"""Shared by ``tests/test_torch_moe.py`` and ``tests/test_torch_hybrid.py``:
the reference ``repro.models`` and the port ``repro_torch.models`` at one
SMOKE config with the same weights, and the port run on the reference's
routing by the near-tie rule of ``tests/torch_routing.py``: under
``routed`` the reference runs first and records its router probabilities
at every MoE call (a ``jax.debug.callback`` around
``moe_a2a._local_moe``), then the port runs on its experts. The two
engines round bfloat16 differently (attention, silu, the Mamba layers).
The routing itself is held on identical inputs by
``tests/test_torch_moe.py``'s routing tests.
"""

import contextlib
import functools

import numpy as np
from torch_routing import Routed, forced

import jax
import jax.numpy as jnp

from repro import configs as rconfigs
from repro.models import build_model as rbuild
from repro.models import moe_a2a as ref_a2a
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference


@functools.lru_cache(maxsize=None)
def models(arch):
    """(reference model, its params, the port's CPU model with them)."""
    ref = rbuild(rconfigs.get_config(arch, smoke=True))
    params = ref.init(jax.random.key(0))
    port = build_model(configs.get_config(arch, smoke=True), device="cpu")
    load_reference(port, params)
    return ref, params, port


# where the reference's callbacks record: a function traced under
# ``routed`` keeps its callback, and a later run of its cached trace
# records into the ``Routed`` it runs under
_SINK = [None]


def _ref_record(probs):
    if _SINK[0] is not None:
        _SINK[0].ref.append(np.asarray(probs))


@contextlib.contextmanager
def routed(k):
    """Yields a ``Routed``: run the reference (jit it inside) before the
    port; each port MoE call takes the reference's next call's experts."""
    rec = Routed(k)
    ref_local = ref_a2a._local_moe

    def ref_spy(flat, params, cfg, e_lo, e_local, cap):
        probs = jax.nn.softmax(flat.astype(jnp.float32) @ params["router"],
                               axis=-1)
        jax.debug.callback(_ref_record, probs, ordered=True)
        return ref_local(flat, params, cfg, e_lo, e_local, cap)

    ref_a2a._local_moe = ref_spy
    _SINK[0] = rec
    try:
        with forced(rec):
            yield rec
    finally:
        ref_a2a._local_moe = ref_local
        _SINK[0] = None


