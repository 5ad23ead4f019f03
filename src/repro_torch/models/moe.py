"""Mixture-of-Experts: the port of ``repro/models/moe.py``.

Tokens are partitioned by destination expert as rows are partitioned by
hash in the query engine, with a static capacity per expert
(``_capacity``, from the call's own token count): a copy past an expert's
capacity is dropped. The reference's two dispatch modes compute the same
function: ``'gspmd'`` lays the buckets out ``[E, C, D]`` over every
expert and leaves the exchange to its partitioner, and ``'a2a'``
(``MOE_DISPATCH``'s default) selects each tp shard's experts' tokens. The
port has no partitioner, so ``moe_ffn`` is ``moe_a2a.moe_ffn_a2a`` for
either value: every expert on this device without a policy, each tp
position's experts under one (``models.sharding.use_axes``).
``MOE_DISPATCH`` is kept for parity with the reference.
"""

from __future__ import annotations

import torch

from . import moe_a2a
from .layers import _init

MOE_DISPATCH = "a2a"        # gspmd | a2a
CAPACITY_FACTOR = 1.25      # expert bucket slack


def init_moe(cfg, generator, device) -> dict:
    """``router`` [D, E] float32 (normal x 0.02); ``experts_w1``,
    ``experts_w3`` [E, D, F] and ``experts_w2`` [E, F, D] in bfloat16; with
    shared experts ``shared_w1``, ``shared_w3`` [D, F n_shared] and
    ``shared_w2`` [F n_shared, D]."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = torch.randn((d, e), generator=generator, dtype=torch.float32,
                         device=device) * 0.02
    p = {"router": router,
         "experts_w1": _init((e, d, f), d, generator, device),
         "experts_w3": _init((e, d, f), d, generator, device),
         "experts_w2": _init((e, f, d), f, generator, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_w1"] = _init((d, fs), d, generator, device)
        p["shared_w3"] = _init((d, fs), d, generator, device)
        p["shared_w2"] = _init((fs, d), fs, generator, device)
    return p


def _capacity(n_tokens: int, cfg, factor: float = None) -> int:
    factor = CAPACITY_FACTOR if factor is None else factor
    c = int(n_tokens * cfg.top_k / cfg.n_experts * factor) + 1
    return max(((c + 127) // 128) * 128, 128)   # lane-aligned


def moe_ffn(params, x, cfg):
    """x: [B, S, D] -> (y, aux_loss). Sort-based static-capacity dispatch
    (``moe_a2a.moe_ffn_a2a``), whatever ``MOE_DISPATCH`` says."""
    return moe_a2a.moe_ffn_a2a(params, x, cfg)
