"""Physical operators (the port of ``repro.core.operators``, main path).

Operators follow Velox's streaming contract, as in the reference::

    op.open()                       # acquire state
    out = op.add_input(batch)       # 0..n output batches, never blocks
    out = op.finish()               # flush blocking state at end of input

The port runs one worker on local ``[cap]`` tensors, eagerly; each operator
body is wrapped in ``kernels.ops.table_op`` only for dispatch accounting.
This slice has FilterProject, HashAggregation (without spill), the fused
per-morsel pipeline, OrderBy and Limit. Joins, Distinct and ScalarBroadcast
come with the join slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

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
    """

    name = "HashAggregation"

    def __init__(self, group_keys: Sequence[str], aggs: Sequence[AggSpec],
                 mode: str = "single", max_groups: int = 4096):
        assert mode in ("partial", "final", "single")
        self.group_keys = tuple(group_keys)
        self.user_specs = tuple(aggs)
        self.mode = mode
        lowered = lower_aggs(self.user_specs)
        self.specs = merge_specs(lowered) if mode == "final" else lowered
        self.max_groups = max_groups
        self._acc: Optional[TorchTable] = None

    def open(self):
        self._acc = None

    def add_input(self, batch):
        part = _aggregate(batch, self.group_keys, self.specs, self.max_groups)
        if self._acc is None:
            self._acc = part
        else:
            merged = concat_tables([self._acc, part])
            self._acc = _aggregate(merged, self.group_keys,
                                   merge_specs(self.specs), self.max_groups)
        return []

    def finish(self):
        if self._acc is None:
            return []
        out, self._acc = self._acc, None
        if self.mode in ("final", "single"):
            out = _finalize_avg(out, self.user_specs)
        return [out]


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


def maybe_compact(table: TorchTable) -> TorchTable:
    """Vector compaction when it at least halves capacity (§3.3.2): move
    valid rows to the front and trim to pow2(valid count) rows (the
    reference's ``exchange.maybe_compact`` at W=1)."""
    n_valid = int(table.num_valid())
    cap = _pow2(max(n_valid, 1))
    if cap * 2 > table.capacity:
        return table
    n = table.capacity
    csum = torch.cumsum(table.validity.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=table.device)
    gather = torch.searchsorted(csum, want, side="left")
    out_valid = gather < n
    idx = torch.clamp(gather, max=n - 1)
    cols = {name: a.index_select(0, idx) for name, a in table.columns.items()}
    return TorchTable(cols, out_valid, table.schema)


# ---------------------------------------------------------------------------
# FusedMorsel: one kernel launch per morsel (filter -> project)
# ---------------------------------------------------------------------------

@table_op
def _fused_morsel(table: TorchTable, stages, program):
    out, _, _ = fused.fused_morsel_program(table, stages, program=program)
    return out


class FusedMorsel(Operator):
    """A collapsed run of FilterProject stages executed as one fused
    kernel launch per morsel (``core.fused``). Created by
    ``fuse_morsel_pipeline``; the probe variant (``join``) comes with the
    join slice."""

    name = "FusedMorsel"

    def __init__(self, stages, join=None):
        if join is not None:
            raise NotImplementedError(
                "FusedMorsel: the fused probe comes with the join slice")
        self.stages = tuple(stages)
        self.join = join
        # lowered programs per input signature (names, dtypes, shapes)
        self._programs = {}

    def add_input(self, batch):
        program = None
        if batch.validity.is_cuda:
            sig = tuple((n, a.dtype, a.dim()) for n, a in batch.columns.items())
            program = self._programs.get(sig)
            if program is None:
                program = fused.lower_stages(batch, self.stages)
                self._programs[sig] = program
        return [_fused_morsel(batch, self.stages, program)]


def fuse_morsel_pipeline(pipe: Pipeline) -> None:
    """Collapse the scan pipeline's runs of non-compacting FilterProjects
    into ``FusedMorsel`` operators: one kernel launch per morsel instead of
    one per stage, with no intermediate morsel materialised. A lone
    FilterProject stays unfused (same launch count either way); compacting
    stages keep their own operators."""
    new_ops: List[Operator] = []
    run: List[FilterProject] = []

    def flush():
        if len(run) >= 2:
            new_ops.append(FusedMorsel(
                [(fp.filter_expr, fp.projections) for fp in run]))
        else:
            new_ops.extend(run)
        run.clear()

    for op in pipe.ops:
        if isinstance(op, FilterProject) and not op.compact:
            run.append(op)
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

