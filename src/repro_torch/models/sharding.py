"""Sharding policy: maps tensor roles to partition specs on a model mesh,
the port of ``repro/models/sharding.py``.

* ``dp`` axes shard the batch (and FSDP-shard parameters/optimizer state),
* the ``tp`` axis shards heads / ffn-hidden / vocab / experts (and the
  KV-cache sequence dimension during decode).

The port runs one process over the positions of a
``launch.mesh.ModelMesh`` (a device may stand for several positions), as
``launch.mesh.EngineMesh`` runs the engine's workers, so the policy is
applied as placements, not as constraints for a partitioner:

* ``param_spec(name, shape, axes)`` gives a parameter's spec by its port
  name (``layers.3.mixer.wq``, ``opt.m.embed``, ...) and per-layer shape.
  The reference stacks a decoder's layers on a leading group axis; the
  spec of such a leaf is the reference's without that axis.
* ``NamedSharding(mesh, spec)`` divides each dimension by the product of
  its axes' sizes (``shard_shape``, JAX's rule); ``device_put(x,
  sharding)`` returns a ``ShardedTensor`` with one local tensor for each
  mesh position on that position's device, ``.full()`` assembles it.
  ``params_shardings``, ``batch_shardings`` and ``cache_shardings`` give
  the placements of a parameter dict or ``TrainState``, of
  ``input_specs`` and of ``cache_specs``.
* ``act_spec(shape, role, axes)`` is the spec that the reference's
  ``shard_act`` sets on an activation. ``shard_act(x, role)`` returns
  ``x``: no partitioner reads a constraint here, and the port's models do
  not call it. ``models.moe_a2a`` reads the active policy
  (``use_axes``) to split its experts across the tp positions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Axes:
    dp: Tuple[str, ...] = ()          # e.g. ("pod", "data")
    tp: Optional[str] = None          # e.g. "model"
    dp_size: int = 1
    tp_size: int = 1
    # ZeRO stage for the dp axes: 3 = params + optimizer dp-sharded; 1 =
    # params replicated on dp (only optimizer state dp-sharded)
    zero_stage: int = 3

    @property
    def dp_spec(self):
        return self.dp if len(self.dp) != 1 else self.dp[0]


class PartitionSpec(tuple):
    """A spec: one entry a dimension, each None, an axis name or a tuple of
    names (the dimension split over their product, the first the major);
    dimensions past its length are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_ACTIVE: list = []


@contextlib.contextmanager
def use_axes(axes: Optional[Axes], mesh=None):
    _ACTIVE.append((axes, mesh))
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_axes() -> Optional[Axes]:
    return _ACTIVE[-1][0] if _ACTIVE else None


def current_mesh():
    return _ACTIVE[-1][1] if _ACTIVE else None


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


_ROLES = ("tokens", "hidden", "heads", "ffn", "logits", "experts",
          "kv_cache", "mamba_state")


def act_spec(shape, role: str, axes: Axes) -> Optional[PartitionSpec]:
    """The spec the reference's ``shard_act`` sets on an activation of
    ``shape`` in ``role`` under ``axes`` (None where it sets none). Roles:
    tokens [B,S] | hidden [B,S,D] | heads [B,S,H,dh] | ffn [B,S,F] |
    logits [B,S,V] | experts [E,C,D] | kv_cache [B,S,K,dh] |
    mamba_state [B,DI,N]."""
    dp, tp = axes.dp_spec, axes.tp
    if role == "tokens":
        return P(dp, None)
    if role == "hidden":
        return P(dp, None, None)
    if role == "heads":
        if _div(shape[2], axes.tp_size):
            return P(dp, None, tp, None)
        return P(dp, None, None, None)
    if role in ("ffn", "logits"):
        return P(dp, None, tp)
    if role == "experts":
        return P(tp, None, None) if _div(shape[0], axes.tp_size) else None
    if role == "kv_cache":                # seq on tp
        if _div(shape[0], axes.dp_size) and shape[0] > 1:
            return P(dp, tp, None, None)
        # batch too small (long-context decode): seq over everything
        return P(None, tuple(axes.dp) + ((tp,) if tp else ()), None, None)
    if role == "mamba_state":
        if _div(shape[0], axes.dp_size) and shape[0] > 1:
            return P(dp, tp, None)
        return P(None, tp, None)
    raise ValueError(role)


def shard_act(x, role: str):
    """``x`` itself (see the module's docstring); an unknown role raises
    ``ValueError``."""
    if role not in _ROLES:
        raise ValueError(role)
    return x


# -- parameter specs ---------------------------------------------------------

def param_spec(path: str, shape: Tuple[int, ...], axes: Axes
               ) -> PartitionSpec:
    """The spec of the parameter (or optimizer leaf, its path holding
    ``opt``) at ``path`` of per-layer ``shape``. fsdp = the innermost dp
    axis (ZeRO-3 storage sharding)."""
    tp = axes.tp
    fsdp = axes.dp[-1] if axes.dp else None
    # ZeRO-1: optimizer moments stay dp-sharded, parameters do not
    if axes.zero_stage == 1 and "opt" not in path:
        fsdp = None

    def ok(dim, size):
        return size and _div(shape[dim], size)

    d = {  # (regex, lambda -> spec); most specific patterns first
        r"experts_(w1|w2|w3)$":   # [E, D, F] / [E, F, D]: EP on tp
            lambda: (tp if ok(0, axes.tp_size) else None,
                     fsdp if ok(1, axes.dp_size) else None, None),
        r"router$": lambda: (None,) * len(shape),
        r"(bias|b_q|b_k|b_v|scale|norm.*|ln.*|a_log|d_skip|dt_bias|gate.*)$":
            lambda: (None,) * len(shape),
        r"embed$": lambda: (tp if ok(0, axes.tp_size) else None, None),
        r"(lm_head)$": lambda: (tp if ok(0, axes.tp_size) else None, None),
        r"(wq|wk|wv|w1|w3|in_proj|up_proj)$":
            lambda: (None,) * (len(shape) - 2)
            + (fsdp if ok(len(shape) - 2, axes.dp_size) else None,
               tp if ok(len(shape) - 1, axes.tp_size) else None),
        r"(wo|w2|out_proj|down_proj)$":
            lambda: (None,) * (len(shape) - 2)
            + (tp if ok(len(shape) - 2, axes.tp_size) else None,
               fsdp if ok(len(shape) - 1, axes.dp_size) else None),
    }
    for pat, fn in d.items():
        if re.search(pat, path):
            return P(*fn())
    return P(*((None,) * len(shape)))


# -- placements --------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A spec on a ``ModelMesh``: where each position's shard of an array
    lies."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, P(*spec)
        for e in self.spec:
            for a in _entry_axes(e):
                if a not in mesh.shape:
                    raise ValueError(f"NamedSharding: axis {a!r} is not one "
                                     f"of the mesh's {mesh.axis_names}")

    def _dims(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"NamedSharding: spec {self.spec} has more "
                             f"entries than the array's {ndim} dimensions")
        return [_entry_axes(e) for e in self.spec] + [()] * (
            ndim - len(self.spec))

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """Each dimension divided by the product of its axes' sizes;
        ``ValueError`` where the product does not divide it (JAX's
        rule)."""
        out = []
        for n, names in zip(global_shape, self._dims(len(global_shape))):
            parts = int(np.prod([self.mesh.shape[a] for a in names]))
            if n % parts:
                raise ValueError(f"NamedSharding: dimension {n} does not "
                                 f"split into {parts} shards over {names}")
            out.append(n // parts)
        return tuple(out)

    def index(self, position, global_shape) -> Tuple[slice, ...]:
        """The slices of the global array held at mesh ``position``."""
        local = self.shard_shape(global_shape)
        coords = dict(zip(self.mesh.axis_names, position))
        out = []
        for size, names in zip(local, self._dims(len(global_shape))):
            i = 0
            for a in names:          # the first axis the major
                i = i * self.mesh.shape[a] + coords[a]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class ShardedTensor:
    """A global array placed by a ``NamedSharding``: ``shards`` holds one
    tensor for each mesh position (an object array of the mesh's shape),
    on that position's device."""

    def __init__(self, shards: np.ndarray, sharding: NamedSharding,
                 shape: Tuple[int, ...], dtype: torch.dtype):
        self.shards, self.sharding = shards, sharding
        self.shape, self.dtype = torch.Size(shape), dtype

    @property
    def mesh(self):
        return self.sharding.mesh

    def local(self, position) -> torch.Tensor:
        return self.shards[tuple(position)]

    def _distinct(self):
        """(index, position) of each distinct shard, in position order."""
        seen = {}
        for pos in self.mesh.positions():
            idx = self.sharding.index(pos, self.shape)
            key = tuple((s.start, s.stop) for s in idx)
            seen.setdefault(key, (idx, pos))
        return list(seen.values())

    def region(self, index: Tuple[slice, ...], position, device=None
               ) -> torch.Tensor:
        """The global array's ``index`` (slices with steps of 1) on
        ``device`` (default: ``position``'s): the local shard of
        ``position`` itself when it is exactly that region, else copied
        together from the shards that hold it (an all-gather)."""
        device = self.mesh.device_at(position) if device is None else device
        index = tuple(index) + (slice(None),) * (len(self.shape) - len(index))
        want = [s.indices(n)[:2] for s, n in zip(index, self.shape)]
        own = self.sharding.index(position, self.shape)
        mine = self.local(position)
        if [(s.start, s.stop) for s in own] == want and mine.device == device:
            return mine
        out = torch.empty([b - a for a, b in want], dtype=self.dtype,
                          device=device)
        for idx, pos in self._distinct():
            lo = [max(a, s.start) for (a, _), s in zip(want, idx)]
            hi = [min(b, s.stop) for (_, b), s in zip(want, idx)]
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            src = tuple(slice(l - s.start, h - s.start)
                        for l, h, s in zip(lo, hi, idx))
            dst = tuple(slice(l - a, h - a)
                        for l, h, (a, _) in zip(lo, hi, want))
            out[dst] = self.local(pos)[src].to(device)
        return out

    def full(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the first position's
        device)."""
        first = next(self.mesh.positions())
        return self.region((), first, device)

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec!r})")


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """Place ``x`` (a tensor on any device, or a ``ShardedTensor``):
    each mesh position gets a copy of its shard on its own device."""
    if isinstance(x, ShardedTensor):
        x = x.full()
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    local = sharding.shard_shape(x.shape)
    for pos in mesh.positions():
        t = torch.empty(local, dtype=x.dtype, device=mesh.device_at(pos))
        shards[pos] = t.copy_(x[sharding.index(pos, x.shape)])
    return ShardedTensor(shards, sharding, tuple(x.shape), x.dtype)


def tree_map(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of NamedTuples, dicts,
    lists and tuples whose leaves are tensors (or ``ShardedTensor``s);
    ``path`` joins the NamedTuple fields, dict keys and list indices with
    dots (``opt.m.layers.0.mixer.wq``)."""
    def sub(key):
        return f"{path}.{key}" if path else str(key)

    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     path=sub(f)) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=sub(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   path=sub(i)) for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def params_shardings(params, axes: Axes, mesh):
    """A ``NamedSharding`` for each leaf of a parameter dict, a
    ``TrainState`` or any tree of them (paths as ``tree_map`` forms them,
    so an AdamW moment's holds ``opt``)."""
    return tree_map(lambda path, leaf: NamedSharding(
        mesh, param_spec(path, tuple(leaf.shape), axes)), params)


def batch_shardings(batch_specs, axes: Axes, mesh):
    """Shardings for a train/prefill batch: leading batch dim on dp."""
    def one(_, spec):
        b = spec.shape[0]
        if _div(b, axes.dp_size) and b > 1:
            return NamedSharding(mesh, P(*((axes.dp_spec,)
                                           + (None,) * (len(spec.shape) - 1))))
        return NamedSharding(mesh, P(*((None,) * len(spec.shape))))

    return tree_map(one, batch_specs)


def _cache_spec(shape, seq_len: int, axes: Axes) -> list:
    spec_axes = [None] * len(shape)
    # find the sequence axis (== seq_len or the encdec self buffer)
    seq_dims = [i for i, d in enumerate(shape) if d == seq_len and i > 0]
    batch_dims = [i for i, d in enumerate(shape)
                  if _div(d, axes.dp_size) and d > 1]
    if seq_dims:
        sd = seq_dims[-1] if len(shape) >= 4 else seq_dims[0]
        if batch_dims and batch_dims[0] < sd:
            spec_axes[batch_dims[0]] = axes.dp_spec
            spec_axes[sd] = axes.tp
        else:
            spec_axes[sd] = tuple(axes.dp) + ((axes.tp,) if axes.tp else ())
    else:
        # recurrent state: shard batch if possible, else biggest
        # tp-divisible dim
        if batch_dims:
            spec_axes[batch_dims[0]] = axes.dp_spec
        for i in range(len(shape) - 1, 0, -1):
            if i != (batch_dims[0] if batch_dims else -1) \
                    and _div(shape[i], axes.tp_size):
                spec_axes[i] = axes.tp
                break
    return spec_axes


def cache_shardings(cache_specs, seq_len: int, axes: Axes, mesh,
                    groups: int = 1):
    """Shardings for decode caches by leaf-shape heuristics, the
    reference's: KV caches carry the seq_len dimension -> shard it on tp
    (and on dp too when the batch can't shard); recurrent states shard
    their big inner dim on tp. A decoder LM's caches are a list, one a
    layer, of leaves that the reference stacks ``[groups, ...]``
    (``groups`` = ``n_layers // block_period``): such a leaf's spec is the
    reference's for ``[groups, *shape]`` without its first entry. The
    encoder-decoder's stacked caches (a dict) are read as they are."""
    if isinstance(cache_specs, list):
        return tree_map(lambda _, spec: NamedSharding(mesh, P(*_cache_spec(
            (groups,) + tuple(spec.shape), seq_len, axes)[1:])), cache_specs)
    return tree_map(lambda _, spec: NamedSharding(mesh, P(*_cache_spec(
        tuple(spec.shape), seq_len, axes))), cache_specs)


def placed_bytes(tree, shardings) -> int:
    """Bytes one mesh position holds of ``tree`` placed by ``shardings``
    (every position holds shards of the same shapes)."""
    total = [0]

    def add(_, leaf, sh):
        n = int(np.prod(sh.shard_shape(tuple(leaf.shape))))
        total[0] += n * torch.empty((), dtype=leaf.dtype).element_size()

    tree_map(add, tree, shardings)
    return total[0]

