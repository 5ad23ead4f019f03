"""Segmented aggregates: the port of ``repro/kernels/segmented_agg.py``.

``segmented_sum`` (float32) and ``segmented_int_sum`` (int32, wrapping at
2^31) sum ``values`` per group id, ``segmented_minmax`` takes each group's
min or max (float32 or int32); ids outside ``[0, num_groups)`` are
dropped. For a CUDA tensor each launches its kernel in
``csrc/segmented_agg.cu`` (the source says what bounds them and how they
are built); for a CPU tensor each runs its plain PyTorch version:
``index_add_`` (sums) or ``scatter_reduce`` (min/max) into a
``num_groups + 1`` buffer whose last slot takes the dropped rows.

``STACKED_GROUP_LIMIT`` and ``stacked_group_capacity`` size inter-query
batches (``core.batch``, ``core.scheduler``).

Under ``launch.roofline.count_program`` a call of N rows and G groups
reports N operations (an add, or a min or max, a row) and ``4 N + (N + G)
* size`` bytes: the ids read, every row's value read, the G results
written once (``size`` the values' element bytes). Rows 2-4's bounds in
``PERF.md`` count the values of the live rows alone, which a count on
``meta`` cannot see, so the count is the bound with every row live.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops

_LIB = "segmented_agg"
# (gids, values, n, num_groups, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]
# (gids, values, n, num_groups, is_min, out, stream)
_MINMAX_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p]
_INT32_MAX = 2 ** 31 - 1

# Stacked group bound of inter-query batching, the reference's value. There
# it is the Pallas kernels' dispatch bound (their one-hot slabs live in
# VMEM); the CUDA kernels here take any group count, so in the port it is a
# batch-size policy only. It stays so that the port's scheduler forms the
# same batches as the reference's and their counters compare.
STACKED_GROUP_LIMIT = 1 << 16


def stacked_group_capacity(max_groups: int, limit: int = STACKED_GROUP_LIMIT
                           ) -> int:
    """How many queries can stack into one segmented aggregation.

    Inter-query batching (``core.batch``) stacks B compatible aggregations
    by remapping ``group_id = query_id * max_groups + local_group``, so the
    kernels see one segmented problem of ``B * max_groups`` groups. The
    scheduler caps batches at the largest power of two B with ``B *
    max_groups <= limit`` (a power of two because member lanes pad up to
    one); a query whose ``max_groups`` alone exceeds ``limit`` gets
    capacity 1: solo execution. Raises ``ValueError`` for ``max_groups <=
    0``.
    """
    if max_groups <= 0:
        raise ValueError("max_groups must be positive")
    cap = limit // max_groups
    if cap <= 1:
        return 1
    return 1 << (cap.bit_length() - 1)


def segmented_sum_plain(gids: torch.Tensor, values: torch.Tensor,
                        num_groups: int) -> torch.Tensor:
    """Plain float32 version: ``zeros(G + 1).index_add_`` and a slice."""
    return _plain(gids, values.to(torch.float32), num_groups)


def segmented_int_sum_plain(gids: torch.Tensor, values: torch.Tensor,
                            num_groups: int) -> torch.Tensor:
    """Plain int32 version (wraps at 2^31 like the int32 reference)."""
    return _plain(gids, values.to(torch.int32), num_groups)


def _plain(gids, values, num_groups):
    seg = torch.where((gids >= 0) & (gids < num_groups), gids, num_groups)
    out = torch.zeros(num_groups + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, seg.long(), values)
    return out[:num_groups]


def segmented_work(gids, values, num_groups, kind=None):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    n = gids.shape[0]
    return n, 4 * n + (n + num_groups) * values.element_size()


@ops.reports("segmented_sum", segmented_work)
def segmented_sum(gids: torch.Tensor, values: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    """gids int32[N], values float32[N] -> float32[num_groups]."""
    if not gids.is_cuda:
        return segmented_sum_plain(gids, values, num_groups)
    return _launch("segmented_sum", "segmented_sum_f32", gids, values,
                   num_groups, torch.float32)


@ops.reports("segmented_int_sum", segmented_work)
def segmented_int_sum(gids: torch.Tensor, values: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """gids int32[N], values int32[N] -> int32[num_groups] (exact; overflow
    wraps like the int32 reference)."""
    if not gids.is_cuda:
        return segmented_int_sum_plain(gids, values, num_groups)
    return _launch("segmented_int_sum", "segmented_sum_i32", gids, values,
                   num_groups, torch.int32)


def _launch(name, symbol, gids, values, num_groups, dtype):
    if gids.dtype != torch.int32 or values.dtype != dtype:
        raise TypeError(f"{name}: wants int32 ids and {dtype} values, got "
                        f"{gids.dtype} and {values.dtype}")
    if gids.dim() != 1 or values.shape != gids.shape:
        raise ValueError(f"{name}: wants two 1-D tensors of one length, got "
                         f"{tuple(gids.shape)} and {tuple(values.shape)}")
    if values.device != gids.device:
        raise ValueError(f"{name}: ids on {gids.device}, values on "
                         f"{values.device}")
    if not (0 <= num_groups < 2 ** 31):
        raise ValueError(f"{name}: num_groups {num_groups} out of range")
    gids, values = gids.contiguous(), values.contiguous()
    out = torch.zeros(num_groups, dtype=dtype, device=gids.device)
    n = gids.numel()
    if n == 0 or num_groups == 0:
        return out
    fn = build.function(_LIB, symbol, _ARGTYPES, device=gids.device)
    stream = torch.cuda.current_stream(gids.device).cuda_stream
    rc = fn(gids.data_ptr(), values.data_ptr(), n, num_groups, out.data_ptr(),
            stream)
    build.check(_LIB, rc, name)
    ops.count_launch(name)
    return out


# ---------------------------------------------------------------------------
# min / max
# ---------------------------------------------------------------------------

def _f32_keys(values: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the IEEE total order of float32
    values (negative values' magnitude bits flipped); the kernel's map."""
    bits = values.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & _INT32_MAX)


def _identity(dtype: torch.dtype, kind: str):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segmented_minmax_plain(gids: torch.Tensor, values: torch.Tensor,
                           num_groups: int, kind: str) -> torch.Tensor:
    """Plain version: ``scatter_reduce(amin | amax, include_self=True)``
    into a ``num_groups + 1`` buffer seeded with the identity. Floats reduce
    as the kernel reduces them: as total-order int32 keys, a NaN replaced by
    the key that wins (so it propagates), and mapped back."""
    if kind not in ("min", "max"):
        raise ValueError(f"segmented_minmax: kind {kind!r}")
    seg = torch.where((gids >= 0) & (gids < num_groups), gids,
                      num_groups).long()
    reduce = "amin" if kind == "min" else "amax"
    if values.dtype == torch.float32:
        ident = _f32_keys(torch.tensor([_identity(torch.float32, kind)]))
        nan_key = -_INT32_MAX - 1 if kind == "min" else _INT32_MAX
        keys = torch.where(torch.isnan(values), nan_key,
                           _f32_keys(values)).to(torch.int32)
        out = torch.full((num_groups + 1,), int(ident[0]), dtype=torch.int32,
                         device=values.device)
        out.scatter_reduce_(0, seg, keys, reduce, include_self=True)
        out = out[:num_groups]
        return (out ^ ((out >> 31) & _INT32_MAX)).view(torch.float32)
    out = torch.full((num_groups + 1,), _identity(values.dtype, kind),
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, seg, values, reduce, include_self=True)
    return out[:num_groups]


@ops.reports("segmented_minmax", segmented_work)
def segmented_minmax(gids: torch.Tensor, values: torch.Tensor,
                     num_groups: int, kind: str) -> torch.Tensor:
    """gids int32[N], values float32 or int32 [N] -> [num_groups] of the
    values' dtype, each group's min (``kind="min"``) or max; a group with
    no row holds the identity (+-inf, or the int32 extremes), as
    ``jax.ops.segment_min/max`` give it."""
    if not gids.is_cuda:
        return segmented_minmax_plain(gids, values, num_groups, kind)
    if kind not in ("min", "max"):
        raise ValueError(f"segmented_minmax: kind {kind!r}")
    symbol = {torch.float32: "segmented_minmax_f32",
              torch.int32: "segmented_minmax_i32"}.get(values.dtype)
    if gids.dtype != torch.int32 or symbol is None:
        raise TypeError(f"segmented_minmax: wants int32 ids and float32 or "
                        f"int32 values, got {gids.dtype} and {values.dtype}")
    if gids.dim() != 1 or values.shape != gids.shape:
        raise ValueError(f"segmented_minmax: wants two 1-D tensors of one "
                         f"length, got {tuple(gids.shape)} and "
                         f"{tuple(values.shape)}")
    if values.device != gids.device:
        raise ValueError(f"segmented_minmax: ids on {gids.device}, values on "
                         f"{values.device}")
    if not (0 <= num_groups < 2 ** 31):
        raise ValueError(f"segmented_minmax: num_groups {num_groups} out of "
                         "range")
    gids, values = gids.contiguous(), values.contiguous()
    out = torch.empty(num_groups, dtype=values.dtype, device=gids.device)
    if num_groups == 0:
        return out
    fn = build.function(_LIB, symbol, _MINMAX_ARGTYPES, device=gids.device)
    stream = torch.cuda.current_stream(gids.device).cuda_stream
    rc = fn(gids.data_ptr(), values.data_ptr(), gids.numel(), num_groups,
            int(kind == "min"), out.data_ptr(), stream)
    build.check(_LIB, rc, "segmented_minmax")
    ops.count_launch("segmented_minmax")
    return out
