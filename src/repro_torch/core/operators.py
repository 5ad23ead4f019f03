"""Physical operators (the port of ``repro.core.operators``, main path).

Operators follow Velox's streaming contract, as in the reference::

    op.open()                       # acquire state
    out = op.add_input(batch)       # 0..n output batches, never blocks
    out = op.finish()               # flush blocking state at end of input

Each worker has its own operator instances over its local ``[cap]``
tensors (the driver runs one per worker), eagerly; each operator body is
wrapped in ``kernels.ops.table_op`` only for dispatch accounting.
The port has FilterProject, HashAggregation (with its flush-to-host
spill mode), Distinct, HashJoin on its open-addressing path (single-match
and expansion probes) and on its sorted-key path, the grace-partitioned
GraceHashJoin over ``core.spill``, the fused per-morsel pipeline with its
probe variant, OrderBy, Limit, ScalarBroadcast and the HostRoundTrip
conversion.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels import hash_probe as hp
from ..kernels import ops as kernel_ops
from ..kernels.radix_histogram import radix_histogram
from ..kernels.ops import table_op
from . import dtypes as dt
from . import fused
from . import relational as rel
from .expr import Expr
from .plan import AggSpec
from .table import TorchTable, concat_tables


class Operator:
    """Velox streaming-operator contract: ``open``, then ``add_input`` per
    batch, then ``finish`` to flush blocking state."""

    name = "operator"

    def open(self) -> None:
        """Acquire per-query state; called once before any input."""

    def add_input(self, batch: TorchTable) -> List[TorchTable]:
        """Consume one batch, return 0..n output batches (never blocks)."""
        raise NotImplementedError

    def finish(self) -> List[TorchTable]:
        """Flush accumulated state at end of input (blocking operators)."""
        return []


class Pipeline(Operator):
    """Compose operators into one streaming stage (the driver's
    ``StreamingScan`` runs its scan-fused chain per morsel through one)."""

    name = "Pipeline"

    def __init__(self, ops_: Sequence[Operator] = ()):
        self.ops: List[Operator] = list(ops_)

    def open(self):
        for op in self.ops:
            op.open()

    def add_input(self, batch):
        outs = [batch]
        for op in self.ops:
            outs = [o for b in outs for o in op.add_input(b)]
        return outs

    def finish(self):
        carry: List[TorchTable] = []
        for op in self.ops:
            fed: List[TorchTable] = []
            for b in carry:
                fed.extend(op.add_input(b))
            fed.extend(op.finish())
            carry = fed
        return carry


# ---------------------------------------------------------------------------
# FilterProject
# ---------------------------------------------------------------------------

@table_op
def _filter_project(table: TorchTable, filter_expr, projections,
                    compact: bool):
    table = fused.apply_stages(table, [(filter_expr, projections)])
    if compact:
        table = table.compact()
    return table


class FilterProject(Operator):
    """Fused filter + projection over one batch."""

    name = "FilterProject"

    def __init__(self, filter_expr: Optional[Expr] = None,
                 projections: Optional[Sequence[Tuple[str, Expr]]] = None,
                 compact: bool = False):
        self.filter_expr = filter_expr
        self.projections = (tuple(projections) if projections is not None
                            else None)
        self.compact = compact

    def add_input(self, batch):
        return [_filter_project(batch, self.filter_expr, self.projections,
                                self.compact)]


# ---------------------------------------------------------------------------
# HashAggregation (partial / final / single)
# ---------------------------------------------------------------------------

_MERGE_KIND = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
               "first": "first"}


def lower_aggs(specs: Sequence[AggSpec]) -> Tuple[AggSpec, ...]:
    """avg -> sum+count for partial phases."""
    lowered: List[AggSpec] = []
    for out, kind, col_ in specs:
        if kind == "avg":
            lowered.append((f"{out}__sum", "sum", col_))
            lowered.append((f"{out}__cnt", "count", col_))
        else:
            lowered.append((out, kind, col_))
    return tuple(lowered)


def merge_specs(specs: Sequence[AggSpec]) -> Tuple[AggSpec, ...]:
    """Specs that merge partial outputs (count -> sum of counts, ...)."""
    return tuple((out, _MERGE_KIND[kind], out) for out, kind, _ in specs)


@table_op
def _aggregate(table: TorchTable, group_keys, specs, max_groups: int):
    dev = table.device
    key_cols = [table.columns[k] for k in group_keys]
    cols, schema = {}, {}
    if key_cols:
        g = rel.group_rows(key_cols, table.validity, max_groups)
        rows = g.key_rows.long()
        for k in group_keys:
            cols[k] = table.columns[k].index_select(0, rows)
            schema[k] = table.schema[k]
        validity = g.group_valid
    else:
        validity = torch.ones(1, dtype=torch.bool, device=dev)
    for out, kind, col_ in specs:
        vals = (torch.zeros(table.capacity, dtype=torch.int32, device=dev)
                if col_ is None else table.columns[col_])
        if kind == "first":
            # carry column: representative value per group
            if key_cols:
                cols[out] = vals.index_select(0, rows)
            else:
                first = torch.argmax(table.validity.to(torch.int32))
                cols[out] = vals[first].reshape(1)
            schema[out] = table.schema[col_]
            continue
        if key_cols:
            cols[out] = rel.segment_agg(vals, g.gids, g.order, table.validity,
                                        max_groups, kind)
        else:
            # the global aggregate is a plain reduction (the reference's
            # jnp.sum, outside any kernel)
            v = table.validity
            zero = torch.zeros((), dtype=vals.dtype, device=dev)
            if kind == "count":
                cols[out] = v.sum(dtype=torch.int32).reshape(1)
            elif kind == "sum":
                cols[out] = torch.where(v, vals, zero).sum(
                    dtype=vals.dtype).reshape(1)
            elif kind == "min":
                big = rel._extreme(vals.dtype, 1).to(dev)
                cols[out] = torch.where(v, vals, big).min().reshape(1)
            elif kind == "max":
                small = rel._extreme(vals.dtype, -1).to(dev)
                cols[out] = torch.where(v, vals, small).max().reshape(1)
            else:
                raise ValueError(kind)
        schema[out] = dt.INT32 if kind == "count" else table.schema[col_]
    return TorchTable(cols, validity, schema)


@table_op
def _finalize_avg(table: TorchTable, user_specs):
    cols = dict(table.columns)
    schema = dict(table.schema)
    for out, kind, _ in user_specs:
        if kind == "avg":
            s = cols.pop(f"{out}__sum")
            c = cols.pop(f"{out}__cnt")
            cols[out] = (s.to(torch.float32)
                         / torch.clamp(c, min=1).to(torch.float32))
            schema.pop(f"{out}__sum"), schema.pop(f"{out}__cnt")
            schema[out] = dt.FLOAT32
    return TorchTable(cols, table.validity, schema)


class HashAggregation(Operator):
    """Concatenation-based streaming aggregation (paper §3.2): aggregate
    each batch, concatenate with the running partial result, re-aggregate.

    mode: 'partial' emits partial columns (avg -> sum+cnt);
          'final'   merges partial columns;
          'single'  complete aggregation in one operator.

    Spill mode (``core.spill``): with a ``SpillManager`` and a flush
    threshold, the accumulator goes to the host tier whenever its occupied
    groups reach ``spill_flush_groups``; ``finish`` restores the flushed
    runs one at a time and merges each into the accumulator with the same
    merge specs.
    """

    name = "HashAggregation"

    _spill_seq = itertools.count()

    def __init__(self, group_keys: Sequence[str], aggs: Sequence[AggSpec],
                 mode: str = "single", max_groups: int = 4096, spill=None,
                 spill_flush_groups: Optional[int] = None):
        assert mode in ("partial", "final", "single")
        self.group_keys = tuple(group_keys)
        self.user_specs = tuple(aggs)
        self.mode = mode
        lowered = lower_aggs(self.user_specs)
        self.specs = merge_specs(lowered) if mode == "final" else lowered
        self.max_groups = max_groups
        self.spill = spill
        self.spill_flush_groups = spill_flush_groups
        self._skey = f"agg{next(self._spill_seq)}"
        self._flushed: List[object] = []
        self._acc: Optional[TorchTable] = None

    def open(self):
        self._acc = None
        self._flushed = []

    def _merge(self, acc: Optional[TorchTable],
               part: TorchTable) -> TorchTable:
        if acc is None:
            return part
        return _aggregate(concat_tables([acc, part]), self.group_keys,
                          merge_specs(self.specs), self.max_groups)

    def add_input(self, batch):
        part = _aggregate(batch, self.group_keys, self.specs, self.max_groups)
        self._acc = self._merge(self._acc, part)
        if (self.spill is not None and self.spill_flush_groups is not None
                and int(self._acc.num_valid()) >= self.spill_flush_groups):
            key = (self._skey, len(self._flushed))
            self.spill.spill_table(key, self._acc)
            self._flushed.append(key)
            self._acc = None
        return []

    def finish(self):
        if self._flushed:
            # restore the flushed runs one at a time: the device holds two
            # max_groups tables however many runs spilled
            acc = self._acc
            for key in self._flushed:
                acc = self._merge(acc, self.spill.restore(key))
            self._acc, self._flushed = acc, []
        if self._acc is None:
            return []
        out, self._acc = self._acc, None
        if self.mode in ("final", "single"):
            out = _finalize_avg(out, self.user_specs)
        return [out]


class Distinct(Operator):
    """Row dedup on key columns (count(distinct ...) rewrites)."""

    name = "Distinct"

    def __init__(self, keys: Sequence[str], max_groups: int = 4096):
        self.keys = tuple(keys)
        self.max_groups = max_groups
        self.agg = HashAggregation(keys, [], "single", max_groups)

    def open(self):
        self.agg.open()

    def add_input(self, batch):
        return self.agg.add_input(batch.select(list(self.keys)))

    def finish(self):
        return self.agg.finish()


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

@table_op
def _compact(table: TorchTable):
    return table.compact()


def compact_table(table: TorchTable) -> TorchTable:
    """Stream-compact a table (paper §3.3.2)."""
    return _compact(table)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# HashJoin (open-addressing table, single-match probe)
# ---------------------------------------------------------------------------

# The reference caps the table at 2^18 slots: its probe keeps the table in
# a TPU core's VMEM (2^18 slots x 8 B = 2 MiB of ~16 MiB, beside the probe
# blocks) and sends larger builds to the sorted-key path. The H100 keeps
# the table in device memory behind a 50 MB L2, so that reason does not
# hold here. The port's cap is the largest table the planner can ask for:
# 2 x its largest build_rows bound (optimizer MAX_CAPACITY, 1 << 24) slots,
# for load 1/2.
MAX_HASH_TABLE_SLOTS = 1 << 25
EMPTY_KEY = -1
_PACKABLE_DTYPES = ("int32", "date32", "dict32")


@table_op
def _build_join_table(build: TorchTable, build_keys):
    key, _ = rel.join_key([build.columns[k] for k in build_keys])
    return rel.join_build(key, build.validity)


@table_op
def _build_hash_table(build: TorchTable, build_keys, table_size: int, pack):
    key = fused.probe_key(build, build_keys, pack, EMPTY_KEY)
    rows = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    return hp.build_table(key, rows, table_size, empty_key=EMPTY_KEY,
                          valid=build.validity)


def _derive_pack(build: TorchTable, build_keys):
    """Injective-pack windows ``((lo, span), ...)`` for a composite
    int-like key, from the valid build rows' min and max (one read back
    from the device), or None when a column is not int-like or the spans'
    product passes the int32 key lane. Every valid build row is inside the
    windows, so the pack needs no verification after the probe."""
    cols = []
    for k in build_keys:
        if build.schema[k].name not in _PACKABLE_DTYPES:
            return None
        cols.append(build.columns[k].to(torch.int64))
    valid = build.validity
    i64 = torch.iinfo(torch.int64)
    stats = [valid.any().to(torch.int64)]
    for c in cols:
        stats += [torch.where(valid, c, i64.max).min(),
                  torch.where(valid, c, i64.min).max()]
    got = torch.stack(stats).tolist()
    pack, prod = [], 1
    for lo, hi in zip(got[1::2], got[2::2]):
        # no valid row: the reference's empty windows
        lo, span = (lo, hi - lo + 1) if got[0] else (0, 1)
        prod *= span
        if prod > rel.INT32_MAX:
            return None
        pack.append((lo, span))
    return tuple(pack)


def _attach_build_payload(probe: TorchTable, build: TorchTable, found,
                          bidx, build_payload, join_type: str) -> TorchTable:
    """Single-match output (output row i is probe row i), shared by the
    standalone probe and the fused morsel kernel: semi/anti filter on
    membership; inner/left_outer gather the build payload by matched row
    (left_outer zero-fills unmatched rows and carries ``__matched``)."""
    if join_type == "left_semi":
        return probe.filter(found)
    if join_type == "left_anti":
        return probe.filter(probe.validity & ~found)
    safe = torch.where(found, bidx, torch.zeros_like(bidx)).long()
    cols = dict(probe.columns)
    schema = dict(probe.schema)
    for n in build_payload:
        v = build.columns[n].index_select(0, safe)
        if join_type == "left_outer":
            mask = found.reshape(found.shape + (1,) * (v.dim() - 1))
            v = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                                 device=v.device))
        cols[n] = v
        schema[n] = build.schema[n]
    if join_type == "left_outer":
        cols["__matched"] = found
        schema["__matched"] = dt.BOOL
        return TorchTable(cols, probe.validity, schema)
    return TorchTable(cols, found, schema)


@table_op
def _probe_join_hash(probe: TorchTable, hash_state, probe_keys,
                     build_payload, join_type: str, max_probes: int, pack):
    """Open-addressing probe (the reference's ``_probe_join_pallas``): one
    table lookup per probe row through ``hash_probe``."""
    build, tk, tv = hash_state
    key = fused.probe_key(probe, probe_keys, pack, EMPTY_KEY)
    found, bidx = hp.hash_probe(tk, tv, key, empty_key=EMPTY_KEY,
                                max_probes=max_probes)
    # a probe key equal to the empty sentinel reads an empty slot as a hit;
    # no such key occupies the table (seal_build refuses a build that holds
    # one, and packed keys are nonnegative), so masking it is exact
    found = found & probe.validity & (key != EMPTY_KEY)
    return _attach_build_payload(probe, build, found, bidx, build_payload,
                                 join_type)


@table_op
def _probe_join_hash_multi(probe: TorchTable, hash_state, probe_keys,
                           build_payload, join_type: str, max_probes: int,
                           max_matches: int, pack):
    """Expansion probe (the reference's ``_probe_join_pallas_multi``):
    probe row i owns output rows ``[i*m, (i+1)*m)``, and its matches come
    in build-row order. The kernel writes 0 into the slots past each
    row's count, so the gather through every slot stays in bounds before
    ``valid`` masks it."""
    build, tk, tv = hash_state
    key = fused.probe_key(probe, probe_keys, pack, EMPTY_KEY)
    count, slots = hp.hash_probe_multi(tk, tv, key, max_matches,
                                       empty_key=EMPTY_KEY,
                                       max_probes=max_probes)
    # sentinel mask, as in the single-match probe: an empty slot compares
    # equal to a sentinel probe key and would report one bogus match
    live = probe.validity & (key != EMPTY_KEY)
    count = torch.where(live, count, torch.zeros_like(count))
    p = key.shape[0]
    j = torch.arange(p * max_matches, dtype=torch.int64, device=key.device)
    probe_idx = j // max_matches
    valid = (j % max_matches) < count.index_select(0, probe_idx)
    build_idx = slots.reshape(-1).long()
    return _expand_join_output(probe, build, probe_idx, build_idx, valid,
                               build_payload, join_type)


@table_op
def _probe_join(probe: TorchTable, build_state, probe_keys, build_keys,
                build_payload, join_type: str, max_matches: int,
                exact: bool, window: int):
    """The sorted-key probe (the reference's ``_probe_join``). An exact key
    takes the first ``max_matches`` rows of its run. A hashed key probes
    its whole hash run, ``window`` rows (the longest run of equal hashes,
    read at seal time), verifies equality of the key columns, and keeps
    each probe row's first ``max_matches`` true matches in run order, so a
    true match sorted behind a colliding key is not dropped (the reference
    takes the first ``max_matches`` rows of the run before verifying)."""
    build, bt = build_state
    key, _ = rel.join_key([probe.columns[k] for k in probe_keys])
    semi = join_type in ("left_semi", "left_anti")
    if semi and exact:
        mask = rel.semi_mask(bt, key, probe.validity)
        if join_type == "left_anti":
            mask = probe.validity & ~mask
        return probe.filter(mask)
    m = max_matches if exact else max(max_matches, window, 1)
    res = rel.join_probe(bt, key, probe.validity, m)
    probe_idx, build_idx, valid = res.probe_idx, res.build_idx, res.valid
    if not exact:   # hashed keys: verify true equality (bucket-then-verify)
        for pk, bk in zip(probe_keys, build_keys):
            pv = probe.columns[pk].index_select(0, probe_idx)
            bv = build.columns[bk].index_select(0, build_idx)
            eq = (pv == bv).all(dim=-1) if pv.dim() > 1 else (pv == bv)
            valid = valid & eq
        if m > max_matches and not semi:
            probe_idx, build_idx, valid = _first_matches(
                probe.capacity, m, max_matches, build_idx, valid)
    return _expand_join_output(probe, build, probe_idx, build_idx, valid,
                               build_payload, join_type)


def _first_matches(p: int, window: int, m: int, build_idx, valid):
    """The first ``m`` live candidates of each probe row's ``window``, in
    order, in the layout of ``m`` output rows a probe row."""
    dev = valid.device
    live = valid.reshape(p, window)
    pos = torch.cumsum(live.to(torch.int64), dim=1) - 1
    keep = (live & (pos < m)).reshape(-1)
    rows = torch.arange(p, dtype=torch.int64, device=dev)[:, None]
    slot = (rows * m + pos).reshape(-1)[keep]
    out_b = torch.zeros(p * m, dtype=build_idx.dtype, device=dev)
    out_v = torch.zeros(p * m, dtype=torch.bool, device=dev)
    out_b[slot] = build_idx[keep]
    out_v[slot] = True
    probe_idx = torch.arange(p * m, dtype=torch.int64, device=dev) // m
    return probe_idx, out_b, out_v


def _expand_join_output(probe: TorchTable, build: TorchTable, probe_idx,
                        build_idx, valid, build_payload,
                        join_type: str) -> TorchTable:
    """Expansion-layout output (the reference's ``_expand_join_output``):
    membership for semi/anti (the sorted-key path with hashed keys), gather
    both sides for inner, append the unmatched probe rows for left_outer."""
    dev = probe.device
    if join_type in ("left_semi", "left_anti"):
        hit = torch.zeros(probe.capacity, dtype=torch.int32, device=dev)
        hit.scatter_reduce_(0, probe_idx, valid.to(torch.int32), "amax")
        mask = probe.validity & (hit > 0)
        if join_type == "left_anti":
            mask = probe.validity & ~mask
        return probe.filter(mask)
    cols, schema = {}, {}
    for n in probe.column_names:
        cols[n] = probe.columns[n].index_select(0, probe_idx)
        schema[n] = probe.schema[n]
    for n in build_payload:
        cols[n] = build.columns[n].index_select(0, build_idx)
        schema[n] = build.schema[n]
    out_valid = valid
    if join_type == "left_outer":
        # append unmatched probe rows with zeroed build payload + match flag
        hit = torch.zeros(probe.capacity, dtype=torch.int32, device=dev)
        hit.scatter_reduce_(0, probe_idx, valid.to(torch.int32), "amax")
        unmatched = probe.validity & (hit == 0)
        for n in probe.column_names:
            cols[n] = torch.cat([cols[n], probe.columns[n]])
        for n in build_payload:
            cols[n] = torch.cat([cols[n], torch.zeros(
                (probe.capacity,) + tuple(cols[n].shape[1:]),
                dtype=cols[n].dtype, device=dev)])
        out_valid = torch.cat([out_valid, unmatched])
        cols["__matched"] = torch.cat(
            [valid, torch.zeros(probe.capacity, dtype=torch.bool,
                                device=dev)])
        schema["__matched"] = dt.BOOL
    return TorchTable(cols, out_valid, schema)


class HashJoin(Operator):
    """Streaming probe against a fully materialised build side, on the
    reference's ``pallas`` path: exact int-like keys (one column, or a
    composite packed injectively into one int32 lane by ``_derive_pack``)
    build an open-addressing table of ``2 * build_rows`` slots rounded up
    to a power of two (``kernels.hash_probe.build_table``). Semi/anti joins
    and joins against a build side the planner proved unique
    (``max_matches == 1``) look each probe batch's keys up with
    ``hash_probe`` (or, fused into the scan, with the fused morsel kernel);
    other inner and left-outer joins expand with ``hash_probe_multi`` into
    ``P x max_matches`` rows, compacted after the probe.

    Where the reference falls back to its sorted-key path, so does the
    port: a non-integer or too wide composite key, a valid build key equal
    to the empty sentinel -1, or a table above ``MAX_HASH_TABLE_SLOTS``.
    The build keys are sorted (``relational.join_build``) and probed by
    searchsorted (``_probe_join``); a hashed key is verified after the
    probe. Each such build counts one ``fallback_probe`` in the kernel
    dispatch, as in the reference. The expansion layout's output of an
    inner or left-outer join is compacted, as in the reference.
    """

    name = "HashJoin"

    def __init__(self, build_keys: Sequence[str], probe_keys: Sequence[str],
                 build_payload: Sequence[str] = (), join_type: str = "inner",
                 max_matches: int = 1, build_rows: Optional[int] = None):
        if join_type not in ("inner", "left_semi", "left_anti", "left_outer"):
            raise ValueError(f"HashJoin: join type {join_type!r}")
        self.build_keys = tuple(build_keys)
        self.probe_keys = tuple(probe_keys)
        self.build_payload = tuple(build_payload)
        self.join_type = join_type
        self.max_matches = max_matches
        self.build_rows = build_rows     # planner's build-side row bound
        self._build_batches: List[TorchTable] = []
        self._hash_state = None          # (build, table_keys, table_vals)
        self._state = None               # (build, sorted BuildTable)
        self._max_probes = 0
        self._exact = True
        self._window = 0                 # longest hash run (hashed keys)
        self._pack = None                # composite-key windows, or None
        self._multi = False              # expansion probe (hash_probe_multi)

    def add_build(self, batch: TorchTable) -> None:
        """Accumulate one build-side batch (device-resident)."""
        self._build_batches.append(batch)

    def _try_hash_build(self, build: TorchTable, pack) -> bool:
        """Build the open-addressing table; False sends the join to the
        sorted-key path. Reads back two scalars from the device: the
        shortfall of occupied slots against valid rows, and the longest
        occupied run (``max_probes``)."""
        cap = build.capacity
        bound = min(self.build_rows or cap, cap)
        table_size = _pow2(max(2 * bound, 2))
        if table_size > MAX_HASH_TABLE_SLOTS:
            return False
        tk, tv = _build_hash_table(build, self.build_keys, table_size, pack)
        # every valid build row must occupy a slot: a shortfall means a key
        # equal to the empty sentinel, whose matches a probe would drop
        short, longest = torch.stack([
            build.validity.sum(dtype=torch.int64)
            - (tk != EMPTY_KEY).sum(dtype=torch.int64),
            hp.longest_run(tk, EMPTY_KEY)]).tolist()
        if short:
            return False
        self._hash_state = (build, tk, tv)
        self._max_probes = hp.probe_bound_of_run(longest, table_size)
        return True

    def seal_build(self) -> None:
        """Concatenate the build side and build its table, or sort it for
        the sorted-key path; probing may start after."""
        if not self._build_batches:
            raise RuntimeError("HashJoin: the build side is empty")
        build = concat_tables(self._build_batches)
        self._build_batches = []
        kt = [build.schema[k] for k in self.build_keys]
        self._exact = len(kt) == 1 and kt[0].name in _PACKABLE_DTYPES
        pack = None
        key_ok = self._exact
        if not key_ok and len(kt) >= 2:
            pack = _derive_pack(build, self.build_keys)
            key_ok = pack is not None
        if key_ok and self._try_hash_build(build, pack):
            self._pack = pack
            self._multi = not (self.join_type in ("left_semi", "left_anti")
                               or self.max_matches == 1)
            return
        kernel_ops.count_dispatch("fallback_probe")
        bt = _build_join_table(build, self.build_keys)
        self._state = (build, bt)
        if not self._exact:
            # one scalar read back: how far a hashed key's probe must walk
            self._window = int(rel.longest_run(bt))

    def add_input(self, batch):
        if self._state is not None:
            out = _probe_join(batch, self._state, self.probe_keys,
                              self.build_keys, self.build_payload,
                              self.join_type, self.max_matches, self._exact,
                              self._window)
            if (self.join_type in ("inner", "left_outer")
                    and self.max_matches > 1):
                out = compact_table(out)
            return [out]
        if self._hash_state is None:
            raise RuntimeError("HashJoin: probe before the build was sealed")
        if self._multi:
            out = _probe_join_hash_multi(
                batch, self._hash_state, self.probe_keys, self.build_payload,
                self.join_type, self._max_probes, self.max_matches,
                self._pack)
            if self.join_type in ("inner", "left_outer"):
                out = compact_table(out)
            return [out]
        return [_probe_join_hash(batch, self._hash_state, self.probe_keys,
                                 self.build_payload, self.join_type,
                                 self._max_probes, self._pack)]


# ---------------------------------------------------------------------------
# GraceHashJoin (spill-aware out-of-core join over core.spill)
# ---------------------------------------------------------------------------

Step = List[TorchTable]


@table_op
def _grace_pids(tables: Step, keys, num_parts: int):
    """Grace-join partition ids of one worker-stacked table (a list of W
    worker tables): each worker's ``relational.partition_ids`` (the
    exchange's partitioner), and the live rows of each (worker, partition)
    from the standalone ``radix_histogram`` over the bins ``w * P + pid``
    (a dead row in the dropped bin ``W * P``, the reference's mask to
    ``P`` at W = 1): one launch a device, over the rows of the workers it
    holds, the host adding the devices' counts (one device off a mesh).
    Returns ``(pids, int32[W, P])``, the pids masked to ``P`` for dead
    rows, the counts on the host when several devices counted."""
    p = num_parts
    w = len(tables)
    pids, bins = [], {}
    for i, t in enumerate(tables):
        pid = rel.partition_ids([t.columns[k] for k in keys], t.validity, p)
        pids.append(torch.where(t.validity, pid, torch.full_like(pid, p)))
        bins.setdefault(t.device, []).append(
            pids[-1] if w == 1 else torch.where(
                t.validity, pid + i * p, torch.full_like(pid, w * p)))
    counts = [radix_histogram(b[0] if len(b) == 1 else torch.cat(b), w * p)
              for b in bins.values()]
    total = counts[0] if len(counts) == 1 else sum(c.cpu() for c in counts)
    return pids, total.reshape(w, p)


def _row_bytes(columns) -> int:
    """Bytes a row takes: its columns' elements and its validity byte."""
    total = 1
    for a in columns.values():
        total += a.element_size() * (a.shape[1] if a.dim() > 1 else 1)
    return total


class _GraceSplit:
    """The device-side partition split of one worker-stacked table: the
    rows of each worker ordered by partition id (stable, so a partition
    keeps its rows' order) and gathered once; partition ``p`` of worker
    ``w`` is copied from a slice of them and padded with dead rows to the
    partition's capacity (``_pow2`` of its largest per-worker count, at
    least 1, the reference's). ``counts`` is the ``[W, P]`` histogram,
    read back once."""

    def __init__(self, tables: Step, pids, counts, num_parts: int):
        self.schema = dict(tables[0].schema)
        self.counts = counts.cpu().tolist()
        self.sorted = []
        for t, pid in zip(tables, pids):
            order = torch.sort(pid, stable=True).indices
            self.sorted.append({n: a.index_select(0, order)
                                for n, a in t.columns.items()})
        self.offsets = [[0, *itertools.accumulate(row)][:-1]
                        for row in self.counts]
        self.caps = [_pow2(max(max(row[p] for row in self.counts), 1))
                     for p in range(num_parts)]
        self._row = _row_bytes(self.sorted[0])

    def rows(self, p: int) -> int:
        """Live rows of partition ``p`` over all workers."""
        return sum(row[p] for row in self.counts)

    def nbytes(self, p: int) -> int:
        """Bytes of partition ``p`` as the reference's host split holds
        them: W workers of ``caps[p]`` rows."""
        return len(self.counts) * self.caps[p] * self._row

    def part(self, p: int) -> Step:
        """Partition ``p``: one table of ``caps[p]`` rows per worker on
        that worker's device, its live rows first, copied out of the
        sorted rows (so that no partition keeps them alive), the tail
        zeroed."""
        cap = self.caps[p]
        out = []
        for w, cols in enumerate(self.sorted):
            lo, n = self.offsets[w][p], self.counts[w][p]
            got = {}
            for name, a in cols.items():
                buf = torch.empty((cap,) + tuple(a.shape[1:]), dtype=a.dtype,
                                  device=a.device)
                buf[:n] = a[lo:lo + n]
                buf[n:] = 0
                got[name] = buf
            dev = next(iter(cols.values())).device
            out.append(TorchTable(
                got, torch.arange(cap, device=dev) < n, self.schema))
        return out


def _one_row_invalid(table: TorchTable) -> TorchTable:
    """A capacity-1, zero-valid-rows table with ``table``'s schema."""
    return TorchTable({n: a[:1] for n, a in table.columns.items()},
                      torch.zeros_like(table.validity[:1]),
                      dict(table.schema))


class GraceHashJoin(Operator):
    """Grace-style partitioned hash join over the spill hierarchy.

    Used by the driver when a join's build side does not fit its device
    reservation (``core.spill.SpillManager``). Both sides are
    hash-partitioned on the join key with the exchange's partitioner, so
    matching rows land in the same partition and each pair joins alone:

    * ``seal_build`` partitions the build side on the device
      (``_grace_pids``, ``_GraceSplit``); partitions stay on the device
      until half the reservation is used, the rest spill (pinned host
      buffers, then paged disk pages as the host tier fills). A resident
      partition never leaves device memory.
    * ``add_input`` partitions each probe batch the same way and stages
      every non-empty slice in the spill store (fully blocking, like the
      classic grace join's first pass).
    * ``finish`` takes partition pairs one at a time: the build partition
      (resident, or restored), a ``HashJoin`` over it (its kernels), its
      staged probe slices replayed; a partition no probe row hashed to is
      dropped unread.

    A batch is a step, a list of W worker tables (the reference's
    ``[W, cap]`` batch; W = 1 for one worker), each on its worker's
    device: the histogram counts the ``W * P`` (worker, partition) bins in
    one launch a device, a partition is W tables, each split, built and
    probed on its worker's device, a spilled one is one ``[W, cap]``
    host-tier partition (``SpillManager.spill_step``, which gives each
    table back on its own device), and the outputs are steps.
    """

    name = "GraceHashJoin"
    _seq = itertools.count()

    def __init__(self, build_keys: Sequence[str], probe_keys: Sequence[str],
                 build_payload: Sequence[str] = (), join_type: str = "inner",
                 max_matches: int = 1, build_rows: Optional[int] = None, *,
                 spill, reservation: int):
        self.build_keys = tuple(build_keys)
        self.probe_keys = tuple(probe_keys)
        self.build_payload = tuple(build_payload)
        self.join_type = join_type
        self.max_matches = max_matches
        self.build_rows = build_rows
        self.spill = spill
        self.reservation = max(int(reservation), 1)
        self.num_partitions: Optional[int] = None   # set by seal_build
        self._skey = f"grace{next(self._seq)}"
        self._build_batches: List[Step] = []
        self._resident: dict = {}        # partition -> Step (device tier)
        self._spilled_build: set = set()
        self._build_rows_by_part: dict = {}
        self._probe_chunks: dict = {}    # partition -> staged chunk count
        self._build_schema: Optional[dict] = None
        # one-row all-invalid prototypes per worker: when every staged
        # slice is empty, finish() still emits one batch of the join's
        # schema so downstream operators see it
        self._build_proto: Optional[Step] = None
        self._probe_proto: Optional[Step] = None

    def add_build(self, step: Step) -> None:
        """Accumulate one build-side step (device-resident until seal)."""
        self._build_batches.append(list(step))

    def seal_build(self) -> None:
        """Partition the build side on the device; spill the partitions
        past half the reservation. Probing may start after."""
        assert self._build_batches, "join build side is empty"
        steps, self._build_batches = self._build_batches, []
        build = [concat_tables([s[w] for s in steps])
                 for w in range(len(steps[0]))]
        self._build_schema = dict(build[0].schema)
        self._build_proto = [_one_row_invalid(t) for t in build]
        # fan out until one partition (+ its probe slice and hash state)
        # fits about half the reservation
        nbytes = sum(t.nbytes() for t in build)
        want = -(-2 * nbytes // self.reservation)
        self.num_partitions = max(min(_pow2(want), 64), 2)
        pids, counts = _grace_pids(build, self.build_keys,
                                   self.num_partitions)
        split = _GraceSplit(build, pids, counts, self.num_partitions)
        del build, pids
        resident_budget = self.reservation // 2
        used = 0
        for p in range(self.num_partitions):
            self._build_rows_by_part[p] = split.rows(p)
            nbytes = split.nbytes(p)
            if used + nbytes <= resident_budget:
                used += nbytes
                self._resident[p] = split.part(p)
            else:
                self.spill.spill_step((self._skey, "build", p),
                                      split.part(p))
                self._spilled_build.add(p)

    def add_input(self, step: Step):
        assert self._build_schema is not None, "probe before build sealed"
        step = list(step)
        if self._probe_proto is None:
            self._probe_proto = [_one_row_invalid(t) for t in step]
        pids, counts = _grace_pids(step, self.probe_keys, self.num_partitions)
        split = _GraceSplit(step, pids, counts, self.num_partitions)
        for p in range(self.num_partitions):
            if split.rows(p) == 0:
                continue
            i = self._probe_chunks.get(p, 0)
            self.spill.spill_step((self._skey, "probe", p, i),
                                  split.part(p))
            self._probe_chunks[p] = i + 1
        return []

    def _inner(self, build: Step, build_rows: int) -> List[HashJoin]:
        joins = []
        for b in build:
            j = HashJoin(self.build_keys, self.probe_keys, self.build_payload,
                         self.join_type, self.max_matches,
                         build_rows=build_rows)
            j.open()
            j.add_build(b)
            j.seal_build()
            joins.append(j)
        return joins

    @staticmethod
    def _probe(joins: List[HashJoin], step: Step) -> List[Step]:
        outs = [j.add_input(b) for j, b in zip(joins, step)]
        return [list(s) for s in zip(*outs)]

    def finish(self):
        outs: List[Step] = []
        for p in range(self.num_partitions):
            chunks = self._probe_chunks.pop(p, 0)
            if chunks == 0:
                # no probe row hashed here: nothing can match; discard
                self._resident.pop(p, None)
                if p in self._spilled_build:
                    self.spill.drop((self._skey, "build", p))
                continue
            if p in self._resident:
                build = self._resident.pop(p)
            else:
                build = self.spill.restore_step((self._skey, "build", p))
            joins = self._inner(build, max(self._build_rows_by_part[p], 1))
            del build
            for i in range(chunks):
                chunk = self.spill.restore_step((self._skey, "probe", p, i))
                outs.extend(self._probe(joins, chunk))
        if not outs and self._probe_proto is not None:
            # every probe slice was empty (e.g. a selective build filter
            # upstream): one all-invalid batch of the join's output schema
            joins = self._inner(self._build_proto, 1)
            outs.extend(self._probe(joins, self._probe_proto))
        return outs


# ---------------------------------------------------------------------------
# FusedMorsel: one kernel launch per morsel (filter -> project -> probe)
# ---------------------------------------------------------------------------

def _run_split(table: TorchTable, stages, runs):
    """All but the last program of a split run (``fused.lower_split``), a
    launch each; returns the table and the stages and program left. A CPU
    table has no programs (``runs`` None): all its stages are left."""
    if runs is None:
        return table, stages, None
    for part, program in runs[:-1]:
        table, _, _ = fused.fused_morsel_program(table, part, program=program)
    return (table,) + runs[-1]


@table_op
def _fused_morsel(table: TorchTable, stages, runs):
    table, stages, program = _run_split(table, stages, runs)
    out, _, _ = fused.fused_morsel_program(table, stages, program=program)
    return out


@table_op
def _fused_morsel_probe(table: TorchTable, hash_state, stages, probe_keys,
                        build_payload, join_type: str, max_probes: int, pack,
                        runs):
    build, tk, tv = hash_state
    table, stages, program = _run_split(table, stages, runs)
    out, found, bidx = fused.fused_morsel_program(
        table, stages,
        probe=dict(tk=tk, tv=tv, probe_keys=probe_keys, pack=pack,
                   empty_key=EMPTY_KEY, max_probes=max_probes),
        program=program)
    return _attach_build_payload(out, build, found, bidx, build_payload,
                                 join_type)


class FusedMorsel(Operator):
    """A collapsed run of FilterProject stages, optionally ending in a
    single-match probe of a sealed ``HashJoin``, executed as one fused
    kernel launch per morsel (``core.fused``), or one a program where the
    run is too large for one (``fused.lower_split``). Created by
    ``fuse_morsel_pipeline``."""

    name = "FusedMorsel"

    def __init__(self, stages, join: Optional[HashJoin] = None):
        self.stages = tuple(stages)
        self.join = join
        # the lowered programs per input signature (names, dtypes, shapes):
        # ((stages, program), ...), one launch each
        self._programs = {}

    def _program(self, batch: TorchTable):
        if not batch.validity.is_cuda:
            return None
        sig = tuple((n, a.dtype, tuple(a.shape[1:]))
                    for n, a in batch.columns.items())
        runs = self._programs.get(sig)
        if runs is None:
            j = self.join
            runs = fused.lower_split(
                batch, self.stages,
                probe_keys=None if j is None else j.probe_keys,
                pack=None if j is None else j._pack)
            self._programs[sig] = runs
        return runs

    def add_input(self, batch):
        runs = self._program(batch)
        j = self.join
        if j is None:
            return [_fused_morsel(batch, self.stages, runs)]
        return [_fused_morsel_probe(batch, j._hash_state, self.stages,
                                    j.probe_keys, j.build_payload,
                                    j.join_type, j._max_probes, j._pack,
                                    runs)]


def fuse_morsel_pipeline(pipe: Pipeline) -> None:
    """Collapse the scan pipeline's runs of non-compacting FilterProjects,
    optionally ending in a sealed ``HashJoin``'s single-match probe, into
    ``FusedMorsel`` operators: one kernel launch per morsel instead of one
    per stage, with no intermediate morsel materialised. A lone
    FilterProject stays unfused (same launch count either way), and so
    does a join with no stage before it; expansion probes and compacting
    stages keep their own operators."""
    new_ops: List[Operator] = []
    run: List[FilterProject] = []

    def stages():
        return [(fp.filter_expr, fp.projections) for fp in run]

    def flush():
        if len(run) >= 2:
            new_ops.append(FusedMorsel(stages()))
        else:
            new_ops.extend(run)
        run.clear()

    for op in pipe.ops:
        if isinstance(op, FilterProject) and not op.compact:
            run.append(op)
        elif (isinstance(op, HashJoin) and run
                and op._hash_state is not None and not op._multi):
            new_ops.append(FusedMorsel(stages(), join=op))
            run.clear()
        else:
            flush()
            new_ops.append(op)
    flush()
    pipe.ops = new_ops


# ---------------------------------------------------------------------------
# OrderBy / Limit
# ---------------------------------------------------------------------------

@table_op
def _head(table: TorchTable, n: int):
    c = table.compact()
    return c.filter(torch.arange(c.capacity, device=c.device) < n)


@table_op
def _order_by(table: TorchTable, keys, descending, limit):
    order = rel.lexsort([table.columns[k] for k in keys], table.validity,
                        list(descending))
    n = table.capacity if limit is None else min(limit, table.capacity)
    idx = order[:n]
    keep = torch.arange(n, device=table.device) < table.num_valid()
    return table.gather(idx, keep)


class OrderBy(Operator):
    """Blocking global sort (optional top-``limit``); accumulates batches
    on the device and sorts once at ``finish``."""

    name = "OrderBy"

    def __init__(self, keys: Sequence[str], descending: Sequence[bool] = None,
                 limit: Optional[int] = None):
        self.keys = tuple(keys)
        self.descending = tuple(descending or [False] * len(self.keys))
        self.limit = limit
        self._batches: List[TorchTable] = []

    def open(self):
        self._batches = []

    def add_input(self, batch):
        self._batches.append(batch)
        return []

    def finish(self):
        table = concat_tables(self._batches)
        self._batches = []
        return [_order_by(table, self.keys, self.descending, self.limit)]


class Limit(Operator):
    """First ``n`` valid rows (blocking: concatenates, then truncates)."""

    name = "Limit"

    def __init__(self, n: int):
        self.n = n
        self._batches: List[TorchTable] = []

    def open(self):
        self._batches = []

    def add_input(self, batch):
        self._batches.append(batch)
        return []

    def finish(self):
        table = concat_tables(self._batches)
        self._batches = []
        return [_head(table, self.n)]



# ---------------------------------------------------------------------------
# Scalar broadcast (uncorrelated scalar subqueries: Q11, Q15, Q22)
# ---------------------------------------------------------------------------

@table_op
def _attach_scalar(batch: TorchTable, scalar: TorchTable, columns):
    s = scalar.compact()
    out = batch
    for n in columns:
        v = s.columns[n][0]
        out = out.with_column(n, v.expand(batch.capacity), s.schema[n])
    return out


class ScalarBroadcast(Operator):
    """Attach the single row of a materialised table to every input row."""

    name = "ScalarBroadcast"

    def __init__(self, columns: Sequence[str]):
        self.columns = tuple(columns)
        self._scalar: Optional[TorchTable] = None

    def set_scalar(self, table: TorchTable) -> None:
        """Provide the materialised 1-row table to attach."""
        self._scalar = table

    def add_input(self, batch):
        if self._scalar is None:
            raise RuntimeError("ScalarBroadcast: no scalar was set")
        return [_attach_scalar(batch, self._scalar, self.columns)]


# ---------------------------------------------------------------------------
# Host/device conversions (CudfToVelox / CudfFromVelox analogues)
# ---------------------------------------------------------------------------

class HostRoundTrip(Operator):
    """Device -> host -> device conversion pair around a host-only operator.

    The paper inserts CudfToVelox/CudfFromVelox when a pipeline holds an
    operator without a GPU version; this models that round trip so its cost
    is measurable: a batch on a CUDA device is copied to host memory and
    back. ``stats["bytes"]`` adds both directions' bytes (the driver keeps
    one such operator per worker, all adding into one dict)."""

    name = "HostRoundTrip"

    def __init__(self, stats: Optional[dict] = None):
        self.stats = stats if stats is not None else {}

    def add_input(self, batch):
        host_cols = {n: a.cpu() for n, a in batch.columns.items()}
        validity = batch.validity.cpu()                   # device -> host
        nbytes = sum(a.numel() * a.element_size() for a in host_cols.values())
        nbytes += validity.numel() * validity.element_size()
        self.stats["bytes"] = self.stats.get("bytes", 0) + 2 * nbytes
        dev = batch.device                                # host -> device
        return [TorchTable({n: a.to(dev) for n, a in host_cols.items()},
                           validity.to(dev), batch.schema)]
