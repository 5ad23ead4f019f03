"""Relational algorithms on capacity-plus-validity batches (the port of
``repro.core.relational``): sorting, group-by and segmented aggregation.

Sums, counts, mins and maxes go through the segmented kernels, as the
reference's ``pallas`` path sends them (``relational.py:226-257``). The
join keys of the open-addressing table are here (``join_key`` for one
int-like column, ``packed_key`` for a composite one), and so is the
exchange's hash partitioning (``hash32``, ``hash_combine``,
``partition_ids``, bit-identical to the reference's), and so is the
sorted-key join (``join_build``, ``join_probe``, ``semi_mask``), which
takes the keys the table cannot: a float, bool or bytes key, a composite
too wide to pack, a build key equal to the table's empty sentinel, or a
build side above the table's cap.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..kernels import ops as kernel_ops
from ..kernels import segmented_agg

INT32_MAX = 2 ** 31 - 1
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# hashing (the reference computes in uint32; the port in int64, masked to
# the low 32 bits, so that every shift is logical and nothing overflows)
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for ``x`` in [0, 2^32) held in int64: the
    product is split at bit 16 so that no partial product passes 2^49."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash32_u(x: torch.Tensor) -> torch.Tensor:
    """The reference's murmur3 finalizer on uint32 values held in int64
    (before its final mask)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer of an int32 column, in [0, 2^31 - 1) (bit
    for bit the reference's ``relational.hash32``)."""
    u = x.to(torch.int32).to(torch.int64) & _U32
    return (_hash32_u(u) & 0x7FFFFFFE).to(torch.int32)


def hash_combine(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combine >= 1 columns into a 31-bit hash key, as the reference does:
    each column is hashed (a non-2-D column after a cast to int32; a bytes
    column after folding its byte lanes as ``folded * 31 + byte``) and
    mixed into ``h ^ (hc + 0x9E3779B9 + (h << 6) + (h >> 2))``, all in
    wrapping uint32."""
    n = cols[0].shape[0]
    h = torch.zeros(n, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        if c.dim() == 2:      # bytes column: fold the byte lanes
            u = torch.zeros_like(h)
            for j in range(c.shape[1]):
                u = (u * 31 + c[:, j].to(torch.int64)) & _U32
        else:
            u = c.to(torch.int32).to(torch.int64) & _U32
        hc = _hash32_u(u) & 0x7FFFFFFE
        h = h ^ ((hc + 0x9E3779B9 + ((h << 6) & _U32) + (h >> 2)) & _U32)
    return (h & 0x7FFFFFFE).to(torch.int32)


def partition_ids(key_cols: Sequence[torch.Tensor], validity: torch.Tensor,
                  num_partitions: int) -> torch.Tensor:
    """Hash-partition rows for the exchange; invalid rows -> partition 0."""
    pid = torch.remainder(hash_combine(list(key_cols)), num_partitions)
    return torch.where(validity, pid, torch.zeros_like(pid))


def partition_layout(pids: torch.Tensor, validity: torch.Tensor,
                     num_partitions: int, part_capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable scatter layout: row -> slot within ``[num_partitions,
    part_capacity]`` (the reference's ``partition_layout``).

    Returns ``(gather_idx int32, out_valid bool)``, both of
    ``num_partitions * part_capacity``: ``gather_idx[p * cap + s]`` is the
    source row of slot s of partition p, 0 for an empty slot. Invalid rows
    go to an overflow bin past the last partition; rows past a partition's
    capacity are dropped (they scatter into one spare slot that is cut
    off)."""
    n, dev = pids.shape[0], pids.device
    total = num_partitions * part_capacity
    pids = pids.to(torch.int64)
    pids = torch.where(validity, pids, torch.full_like(pids, num_partitions))
    order = torch.sort(pids, stable=True).indices
    sorted_pids = pids.index_select(0, order)
    # rank within its partition = position - the partition's first position
    first = torch.searchsorted(
        sorted_pids, torch.arange(num_partitions + 1, device=dev))
    rank = torch.arange(n, device=dev) - first.index_select(0, sorted_pids)
    in_cap = (rank < part_capacity) & (sorted_pids < num_partitions)
    slot = torch.where(in_cap, sorted_pids * part_capacity + rank,
                       torch.full_like(rank, total))
    gather = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    gather.index_put_((slot,), order.to(torch.int32))
    out_valid = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    out_valid.index_put_((slot,), torch.ones_like(slot, dtype=torch.bool))
    return gather[:total], out_valid[:total]


def _sort_key(key: torch.Tensor) -> torch.Tensor:
    """An int32 key whose signed order is the reference's sort order.

    The reference's float sort ties -0.0 with 0.0 and puts every NaN last,
    so floats are canonicalised that way and then mapped to int32 with the
    magnitude bits of negative values flipped (IEEE total order). Integers
    and bools sort as int32."""
    if key.is_floating_point():
        x = key.to(torch.float32)
        x = torch.where(x == 0, torch.zeros_like(x), x)
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        bits = x.view(torch.int32)
        return bits ^ ((bits >> 31) & INT32_MAX)
    return key.to(torch.int32)


def join_key(cols: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
    """Single int32 join key: ``(key, exact)``. Exact for one integer
    column; otherwise the ``hash_combine`` of the columns, and the caller
    must verify equality of the original columns after the join
    (hash-bucket-then-verify, as a hash join does)."""
    if len(cols) == 1 and cols[0].dim() == 1 and not (
            cols[0].is_floating_point() or cols[0].dtype == torch.bool):
        return cols[0].to(torch.int32), True
    return hash_combine(cols), False


def packed_key(cols: Sequence[torch.Tensor], pack: Sequence[Tuple[int, int]],
               empty_key: int = -1) -> torch.Tensor:
    """Injectively pack int columns into one nonnegative int32 key.

    ``pack`` gives a ``(lo, span)`` window per column (the valid build
    rows' range, ``operators._derive_pack``); rows inside every window map
    to a unique key in ``[0, prod(spans))``, any other row to
    ``empty_key``. Values are clipped before folding, so no product
    overflows."""
    n = cols[0].shape[0]
    dev = cols[0].device
    key = torch.zeros(n, dtype=torch.int32, device=dev)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    for c, (lo, span) in zip(cols, pack):
        c = c.to(torch.int32)
        ok = ok & (c >= lo) & (c <= lo + span - 1)
        key = key * span + torch.clamp(c - lo, 0, span - 1)
    return torch.where(ok, key, torch.full_like(key, empty_key))


def lexsort(keys: List[torch.Tensor], validity: torch.Tensor,
            descending: Sequence[bool] = None) -> torch.Tensor:
    """Stable multi-key sort order; invalid rows sort last.

    ``keys[0]`` is the primary key. 2-D (bytes) keys sort by their bytes,
    big-endian, via one pass per byte column."""
    n = validity.shape[0]
    descending = descending or [False] * len(keys)
    order = torch.arange(n, dtype=torch.int64, device=validity.device)

    def _passes(key, desc):
        if key.dim() == 2:  # fixed-width bytes: byte columns right-to-left
            cols = [key[:, j].to(torch.int32) for j in range(key.shape[1])]
            return [(c, desc) for c in reversed(cols)]
        return [(_sort_key(key), desc)]

    # stable passes, least significant first: the last pass applied (the
    # validity) is the most significant, and keys[0] precedes keys[1:]
    all_passes = []
    for key, desc in reversed(list(zip(keys, descending))):
        all_passes.extend(_passes(key, desc))
    all_passes.append(((~validity).to(torch.int32), False))

    for k, desc in all_passes:
        cur = k.index_select(0, order)
        if desc:
            # stable descending without negating (negation corrupts
            # INT32_MIN): stably sort the reversed array and flip the
            # result, which keeps original order among equal keys
            perm = (n - 1 - torch.argsort(cur.flip(0), stable=True)).flip(0)
        else:
            perm = torch.argsort(cur, stable=True)
        order = order.index_select(0, perm)
    return order


class Groups(NamedTuple):
    """Output of ``group_rows``: permutation, dense group ids, count,
    representative row per group, and the group-slot validity mask."""

    order: torch.Tensor        # row permutation, valid rows first, grouped
    gids: torch.Tensor         # int32 group id per *sorted* row; invalid ->
                               # max_groups
    num_groups: torch.Tensor   # 0-d
    key_rows: torch.Tensor     # one representative original row per group
    group_valid: torch.Tensor  # bool[max_groups]


def group_rows(key_cols: List[torch.Tensor], validity: torch.Tensor,
               max_groups: int) -> Groups:
    """Dense group ids via sort + boundary detection (exact for any number
    of key columns; no hashing)."""
    dev = validity.device
    order = lexsort(key_cols, validity)
    valid_sorted = validity.index_select(0, order)
    change = torch.zeros(order.shape, dtype=torch.bool, device=dev)
    for k in key_cols:
        ks = k.index_select(0, order)
        diff = ks[1:] != ks[:-1]
        if ks.dim() == 2:
            diff = diff.any(dim=1)
        change[1:] |= diff
    change &= valid_sorted
    gids = torch.cumsum(change.to(torch.int32), 0, dtype=torch.int32)
    gids = torch.where(valid_sorted, gids, max_groups).to(torch.int32)
    num_groups = (change.sum(dtype=torch.int32)
                  + validity.any().to(torch.int32))

    # representative original row per group (first row of each segment);
    # rows that start no group, or whose id overflows max_groups, write the
    # spare slot max_groups, which is sliced off
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       change[1:]])
    first_of_group = valid_sorted & first
    slot = torch.where(first_of_group, gids, max_groups)
    slot = torch.clamp(slot, max=max_groups).long()
    reps = torch.zeros(max_groups + 1, dtype=torch.int32, device=dev)
    reps.index_put_((slot,), order.to(torch.int32))
    group_valid = torch.arange(max_groups, device=dev) < num_groups
    return Groups(order, gids, num_groups, reps[:max_groups], group_valid)


def segment_agg(values: torch.Tensor, gids: torch.Tensor,
                order: torch.Tensor, validity: torch.Tensor,
                max_groups: int, kind: str) -> torch.Tensor:
    """Aggregate ``values`` per group id; ``kind`` is sum, count, min or
    max.

    The reference's kernel branch: counts and integer sums go to
    ``segmented_int_sum`` (exact, wrapping at 2^31), float sums to
    ``segmented_sum`` (dead rows zeroed first), min and max to
    ``segmented_minmax`` (dead rows carry the reduction identity, so
    dead-lane NaN or inf cannot leak into a group). Unlike the Pallas
    kernels, whose VMEM capped them at ``1 << 16`` groups, the CUDA
    kernels take any group count, so there is no capacity fallback."""
    v = values.index_select(0, order)
    valid_sorted = validity.index_select(0, order)
    seg = torch.where(valid_sorted, gids, max_groups).to(torch.int32)
    if kind == "count":
        kernel_ops.mark_kernel("agg")
        return segmented_agg.segmented_int_sum(
            seg, valid_sorted.to(torch.int32), max_groups)
    if kind not in ("sum", "min", "max"):
        raise ValueError(f"segment_agg: kind {kind!r}")
    if v.dim() != 1 or v.dtype not in (torch.int32, torch.float32):
        raise NotImplementedError(
            f"segment_agg: {kind} over {v.dtype} {tuple(v.shape)}")
    if kind != "sum":
        ident = _extreme(v.dtype, 1 if kind == "min" else -1).to(v.device)
        kernel_ops.mark_kernel("agg")
        return segmented_agg.segmented_minmax(
            seg, torch.where(valid_sorted, v, ident), max_groups, kind)
    # zero dead rows: their values may be NaN/inf (dead-lane arithmetic)
    acc = torch.where(valid_sorted, v, torch.zeros((), dtype=v.dtype,
                                                   device=v.device))
    kernel_ops.mark_kernel("agg")
    if v.dtype == torch.int32:
        return segmented_agg.segmented_int_sum(seg, acc, max_groups)
    return segmented_agg.segmented_sum(seg, acc, max_groups)


# ---------------------------------------------------------------------------
# the sorted-key join (sort + searchsorted; the open-addressing table of
# kernels.hash_probe is the other way to probe)
# ---------------------------------------------------------------------------

class BuildTable(NamedTuple):
    """Sorted join build side (keys, permutation, original validity)."""

    sorted_keys: torch.Tensor   # int32[B], invalid rows pushed to the end
    perm: torch.Tensor          # int64[B] permutation into the build rows
    validity: torch.Tensor      # the build rows' validity


def join_build(keys: torch.Tensor, validity: torch.Tensor) -> BuildTable:
    """Sort the build keys (invalid rows last, as ``INT32_MAX``; a stable
    sort keeps equal keys in build-row order) for searchsorted probes."""
    k = torch.where(validity, keys.to(torch.int32),
                    torch.full_like(keys, INT32_MAX, dtype=torch.int32))
    perm = torch.argsort(k, stable=True)
    return BuildTable(k.index_select(0, perm), perm, validity)


def longest_run(bt: BuildTable) -> torch.Tensor:
    """The longest run of equal keys among the valid sorted build keys, as
    a 0-d int64 tensor (0 for an empty build side)."""
    n = bt.sorted_keys.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int64)
    valid_sorted = bt.validity.index_select(0, bt.perm)
    start = torch.ones(n, dtype=torch.bool, device=bt.perm.device)
    start[1:] = bt.sorted_keys[1:] != bt.sorted_keys[:-1]
    run_id = torch.cumsum(start.to(torch.int64), 0) - 1
    lengths = torch.zeros(n, dtype=torch.int64, device=bt.perm.device)
    lengths.index_add_(0, run_id, valid_sorted.to(torch.int64))
    return lengths.max()


class ProbeResult(NamedTuple):
    """Expanded probe output: per output row the matched build and probe
    indices and liveness, and per probe row its match count."""

    build_idx: torch.Tensor    # int64[P*M] original build row per output row
    probe_idx: torch.Tensor    # int64[P*M] probe row per output row
    valid: torch.Tensor        # bool[P*M]
    match_count: torch.Tensor  # int32[P] matches per probe row


def _run_bounds(bt: BuildTable, probe_keys: torch.Tensor):
    sk = bt.sorted_keys
    pk = probe_keys.to(torch.int32)
    return (torch.searchsorted(sk, pk, side="left"),
            torch.searchsorted(sk, pk, side="right"))


def join_probe(bt: BuildTable, probe_keys: torch.Tensor,
               probe_valid: torch.Tensor, max_matches: int) -> ProbeResult:
    """Expansion probe with the static output capacity ``P * max_matches``:
    probe row i owns output rows ``[i*m, (i+1)*m)``, the first ``m`` rows
    of its key's run in build-row order."""
    p = probe_keys.shape[0]
    m = max_matches
    dev = probe_keys.device
    start, end = _run_bounds(bt, probe_keys)
    count = torch.where(probe_valid, end - start,
                        torch.zeros_like(start)).to(torch.int32)
    j = torch.arange(p * m, dtype=torch.int64, device=dev)
    pi = j // m
    k = j % m
    within = k < count.index_select(0, pi)
    if bt.sorted_keys.shape[0] == 0:      # no build row: no match
        return ProbeResult(torch.zeros_like(pi), pi, within, count)
    b = torch.clamp(start.index_select(0, pi) + k, 0,
                    bt.sorted_keys.shape[0] - 1)
    bidx = bt.perm.index_select(0, b)
    valid = (within & probe_valid.index_select(0, pi)
             & bt.validity.index_select(0, bidx))
    return ProbeResult(bidx, pi, valid, count)


def semi_mask(bt: BuildTable, probe_keys: torch.Tensor,
              probe_valid: torch.Tensor) -> torch.Tensor:
    """Probe rows with at least one match (EXISTS); anti is
    ``probe_valid & ~semi``."""
    start, end = _run_bounds(bt, probe_keys)
    return probe_valid & (end > start)


def _extreme(dtype: torch.dtype, sign: int) -> torch.Tensor:
    """The min (sign +1) or max (sign -1) reduction identity of ``dtype``."""
    if dtype.is_floating_point:
        return torch.tensor(sign * float("inf"), dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if sign > 0 else info.min, dtype=dtype)
