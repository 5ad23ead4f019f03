"""Expert-parallel MoE dispatch: the port of ``repro/models/moe_a2a.py``.

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

``moe_ffn_a2a`` takes the reference's path without a policy
(``moe_a2a.py:86-93``): every expert on this device, plus the shared
experts. Under a policy (``models.sharding.use_axes(axes, mesh)``, a
``launch.mesh.ModelMesh``) whose tp axis divides ``n_experts`` it takes
the reference's ``shard_map`` path (``:95-129``) over the mesh's positions
in one process: the batch splits over dp when dp divides it (each dp
shard's capacity from its own tokens; otherwise every dp row would
compute the same tokens, so one does); tp rank r runs ``_local_moe`` with
experts ``[r e_local, (r + 1) e_local)`` on the device of its position,
on the rank's slice of the expert weights (a ``ShardedTensor`` placed by
``sharding.params_shardings`` gives its local shard in place, gathering
only the dimensions the policy also splits over dp); the ranks' outputs
are summed on rank 0's device in rank order, the reference's ``psum``
(device-to-device copies and adds, no process group), and aux is the tp
mean. The all-reduce reports its bytes to an active
``launch.roofline.count_program``: the result's bytes at each position
that runs it, as an HLO parse counts an all-reduce in each device's
program.
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
    """x [B, S, D] -> (y, aux): every expert on this device, or the
    experts split across the tp positions of the active policy."""
    from .moe import _capacity
    from .sharding import current_axes, current_mesh

    axes, mesh = current_axes(), current_mesh()
    b, s, d = x.shape
    if (axes is None or mesh is None or axes.tp is None
            or cfg.n_experts % axes.tp_size != 0):
        out, aux = _local_moe(x.reshape(b * s, d), params, cfg, 0,
                              cfg.n_experts, _capacity(b * s, cfg))
    else:
        out, aux = _across_tp(params, x, cfg, axes, mesh)
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + _shared({k: _whole(params[k], x.device) for k in (
            "shared_w1", "shared_w2", "shared_w3")}, x)
    return out, aux


def _whole(leaf, device):
    """A parameter leaf as one tensor on ``device``."""
    from .sharding import ShardedTensor
    return leaf.full(device) if isinstance(leaf, ShardedTensor) else leaf


def _rank_leaf(leaf, position, rows: slice, device):
    """Experts ``rows`` of ``leaf`` on ``device``: a ``ShardedTensor``'s
    local shard at ``position`` when it is that slice, else the slice
    gathered; a tensor's slice (a view on its own device)."""
    from .sharding import ShardedTensor
    if isinstance(leaf, ShardedTensor):
        return leaf.region((rows,), position, device)
    return leaf[rows].to(device)


def _across_tp(params, x, cfg, axes, mesh):
    """The reference's ``shard_map`` body at every position, in one
    process -> (out [B * S, D] on x's device, aux)."""
    from ..kernels import ops
    from .moe import _capacity

    b, s, d = x.shape
    tp = axes.tp_size
    e_local = cfg.n_experts // tp
    dp_splits = b % axes.dp_size == 0 and b >= axes.dp_size
    shards = axes.dp_size if dp_splits else 1
    local_tokens = b * s // shards
    cap = _capacity(max(local_tokens, 1), cfg)
    dp_sizes = [mesh.shape[a] for a in axes.dp]
    outs, aux = [], None
    for i in range(shards):
        coords, rest = {}, i
        for a, n in reversed(list(zip(axes.dp, dp_sizes))):
            coords[a], rest = rest % n, rest // n
        xs = x[i * (b // shards):(i + 1) * (b // shards)].reshape(-1, d)
        partials, auxes = [], []
        for r in range(tp):
            pos = mesh.position(**coords, **{axes.tp: r})
            dev = mesh.device_at(pos)
            rows = slice(r * e_local, (r + 1) * e_local)
            p_local = {"router": _rank_leaf(params["router"], pos,
                                            slice(None), dev)}
            for k in ("experts_w1", "experts_w3", "experts_w2"):
                p_local[k] = _rank_leaf(params[k], pos, rows, dev)
            o, a = _local_moe(xs.to(dev), p_local, cfg, r * e_local, e_local,
                              cap)
            partials.append(o)
            auxes.append(a)
        # combine: the all-reduce of the output over the tp ranks
        home = partials[0].device
        total = partials[0]
        for o in partials[1:]:
            total = total + o.to(home)
        ops.report_work("moe_a2a.all_reduce", collective_bytes=(
            axes.dp_size * tp * total.numel() * total.element_size()
            // shards))
        outs.append(total.to(x.device))
        if aux is None:     # the first dp shard's, as the reference's P()
            tot = auxes[0]
            for a in auxes[1:]:
                tot = tot + a.to(tot.device)
            aux = (tot / tp).to(x.device)
    return torch.cat(outs), aux


def _shared(params, x):
    h = F.silu(x @ params["shared_w1"]) * (x @ params["shared_w3"])
    return h @ params["shared_w2"]
