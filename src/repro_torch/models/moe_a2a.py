"""Expert-parallel MoE dispatch without a mesh: the port of
``repro/models/moe_a2a.py``'s local path.

``_local_moe`` computes the contribution of experts ``[e_lo, e_lo +
e_local)`` for all tokens: top-k routing in float32, the Switch aux loss,
a stable sort of the token copies by expert, a static capacity ``cap`` per
expert that drops the copies past it, the experts' SwiGLU over ``[E_loc,
cap, D]`` buckets (``torch.bmm``) and the weighted scatter back to token
order. No TPU kernel computes any of it in the reference, so plain torch is
its counterpart. Every step stays on the device: shapes are Python ints,
the sort, ``searchsorted`` and the scatters run there, and nothing is read
back. The scatters are out of place, so autograd differentiates through
the routing weights, the gather and the combine.

``moe_ffn_a2a`` takes the reference's path without a mesh
(``moe_a2a.py:197-204``): every expert on this device, plus the shared
experts. The ``shard_map`` path (each card's experts, one all-reduce of the
output) waits for ``ROADMAP.md`` Queue A item 6 (sharding).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import DTYPE


class Routing(NamedTuple):
    """One call's routing: ``topi`` [N, k] (each token's experts, the
    heaviest first), ``slot_tok`` and ``slot_w`` [E_loc * cap] (the token
    and bfloat16 gate weight of each expert slot; an empty slot holds token
    0 and weight 0) and the aux loss (float32, 0-d)."""
    topi: torch.Tensor
    slot_tok: torch.Tensor
    slot_w: torch.Tensor
    aux: torch.Tensor


def _gate(flat, router, k: int):
    """flat [N, D] -> (router probabilities [N, E] in float32, each token's
    k heaviest experts' weights renormalized to sum 1, their indices)."""
    probs = torch.softmax(flat.float() @ router, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def _route(flat, params, cfg, e_lo: int, e_local: int, cap: int) -> Routing:
    """flat [N, D] -> the ``Routing`` of experts ``[e_lo, e_lo +
    e_local)``, as ``moe_a2a.py:36-71`` computes it."""
    n = flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dev = flat.device
    probs, topw, topi = _gate(flat, params["router"], k)

    # aux load-balance loss (Switch): E * <f_e, p_e>; the counts are exact
    # in float32, so the order of the adds does not matter
    me = probs.mean(dim=0)
    eid = topi.reshape(-1)
    ones = torch.ones((n * k,), dtype=torch.float32, device=dev)
    assign = torch.zeros((e,), dtype=torch.float32, device=dev).index_add(
        0, eid, ones) / (n * k)
    aux = e * torch.sum(me * assign)

    # dispatch: partition the token copies by expert (the exchange)
    tok = torch.arange(n * k, device=dev) // k
    w = topw.reshape(-1).to(DTYPE)
    rel = eid - e_lo
    sort_key = torch.where((rel >= 0) & (rel < e_local), rel, e_local)
    sorted_rel, order = torch.sort(sort_key, stable=True)
    first = torch.searchsorted(sorted_rel, torch.arange(
        e_local + 1, device=dev, dtype=sorted_rel.dtype))
    rank = torch.arange(n * k, device=dev) - first[sorted_rel]
    keep = (sorted_rel < e_local) & (rank < cap)            # capacity drop
    # a dropped copy goes to the extra last slot, which is cut off
    slot = torch.where(keep, sorted_rel * cap + rank, e_local * cap)
    slots = e_local * cap + 1
    slot_tok = torch.zeros((slots,), dtype=torch.int64, device=dev).scatter(
        0, slot, tok[order])[:-1]
    slot_w = torch.zeros((slots,), dtype=DTYPE, device=dev).scatter(
        0, slot, w[order])[:-1]
    return Routing(topi, slot_tok, slot_w, aux)


def _experts(flat, params, r: Routing, e_local: int, cap: int):
    """The experts' SwiGLU over their buckets and the weighted combine in
    bfloat16 -> [N, D]. An empty slot's bucket row is zeroed, so it adds an
    exact zero to token 0."""
    d = flat.shape[1]
    buckets = flat[r.slot_tok].reshape(e_local, cap, d)
    buckets = buckets * (r.slot_w.reshape(e_local, cap, 1) != 0)
    h = F.silu(torch.bmm(buckets, params["experts_w1"]))
    h = h * torch.bmm(buckets, params["experts_w3"])
    y = torch.bmm(h, params["experts_w2"])
    y_flat = y.reshape(e_local * cap, d) * r.slot_w[:, None]
    return torch.zeros_like(flat).index_add(0, r.slot_tok, y_flat)


def _local_moe(flat, params, cfg, e_lo: int, e_local: int, cap: int):
    """flat [N, D] -> (this device's experts' output [N, D], aux)."""
    r = _route(flat, params, cfg, e_lo, e_local, cap)
    return _experts(flat, params, r, e_local, cap), r.aux


def moe_ffn_a2a(params, x, cfg):
    """x [B, S, D] -> (y, aux): every expert on this device."""
    from .moe import _capacity

    b, s, d = x.shape
    out, aux = _local_moe(x.reshape(b * s, d), params, cfg, 0, cfg.n_experts,
                          _capacity(b * s, cfg))
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + _shared(params, x)
    return out, aux


def _shared(params, x):
    h = F.silu(x @ params["shared_w1"]) * (x @ params["shared_w3"])
    return h @ params["shared_w2"]
