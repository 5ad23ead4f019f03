"""Inter-query batching (the port of ``repro.core.batch``): stack compatible
small queries into one scan.

A serving workload of many concurrent small point-lookup, filter and
aggregate queries is the regime where fixed per-query dispatch cost dwarfs
compute. This module runs such queries together:

* ``extract_shape`` inspects an optimized single-table plan (scan ->
  filter/project chain -> optional aggregation -> trailing stages) and,
  when eligible, lifts it into a shared ``BatchProgram`` with the filter
  literals replaced by ``ParamRef`` placeholders. Two queries that differ
  only in those literals produce the *same interned program object*, so
  the scheduler's compatibility grouping is a dict-key check and the
  lowered kernel program is built once per program.

* ``run_batch`` executes B member queries as ONE scan: every morsel goes
  through one ``fused.fused_batch_program`` launch that evaluates the shared
  projections once plus a predicate lane per member
  (``kernels/csrc/fused_batch.cu``); aggregations stack into one segmented
  aggregation per spec via ``group_id = member * max_groups + local_group``
  (``kernels.segmented_agg.stacked_group_capacity``), and results are split
  per member on the way out.

Correctness contract, the reference's: a member's batched result equals
its solo execution -- row sets, row order (morsel order for row queries,
ascending group order for aggregates) and integer values exactly, float
sums up to reduction order.

Where the reference jits a program per (program, lane count, morsel spec),
the port runs eagerly and caches the lowered register program on the
``BatchProgram``, keyed by lane count and input dtypes, so no morsel
lowers anew. A stacked ``LIKE`` (``BytesMatch``) or ``EXTRACT(YEAR)``
(``Year``) predicate lowers to the fused kernels' BYTESMATCH and YEAR, as
a solo run's does; both are lane-invariant, so they run once before the
lane loop. ``ParamRef`` lives in ``core.expr`` and
``apply_batched_stages`` (the kernel's plain version) in ``core.fused``;
both are importable from here.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..kernels import segmented_agg
from ..kernels.ops import table_op
from . import dtypes as dt
from . import fused
from . import plan as P
from . import relational as rel
from .expr import (BinaryOp, BytesMatch, ColumnRef, Expr, IsIn, Literal,
                   ParamRef, PrefixCode, UnaryOp, Year)  # ParamRef re-exported
from .fused import apply_batched_stages  # noqa: F401  (re-exported)
from .operators import lower_aggs
from .streaming import ScanStats
from .table import TorchTable, concat_tables

_AGG_KINDS = ("sum", "count", "min", "max", "avg")


class Ineligible(Exception):
    """Plan shape the batching layer cannot stack (internal signal)."""


# ---------------------------------------------------------------------------
# parameterized predicates
# ---------------------------------------------------------------------------

def _parameterize(e: Expr, dtypes: list, values: list) -> Expr:
    """Copy a filter predicate with every ``Literal`` replaced by a
    ``ParamRef`` (walk order assigns indices, so structurally identical
    predicates parameterize identically). Literal dtypes join the program
    signature: ``x < 5`` (int32) and ``x < 5.5`` (float32) lower different
    programs and must not group."""
    if isinstance(e, Literal):
        idx = len(dtypes)
        dtypes.append(e.dtype)
        values.append(e.value)
        return ParamRef(idx, e.dtype)
    if isinstance(e, ColumnRef):
        return e
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, _parameterize(e.lhs, dtypes, values),
                        _parameterize(e.rhs, dtypes, values))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, _parameterize(e.operand, dtypes, values))
    if isinstance(e, IsIn):
        # membership sets stay literal (they shape the program)
        return IsIn(_parameterize(e.operand, dtypes, values), e.values)
    if isinstance(e, BytesMatch):
        return BytesMatch(_parameterize(e.operand, dtypes, values),
                          e.parts, e.mode)
    if isinstance(e, Year):
        return Year(_parameterize(e.operand, dtypes, values))
    if isinstance(e, PrefixCode):
        return PrefixCode(_parameterize(e.operand, dtypes, values), e.n)
    raise Ineligible(f"unsupported expression {type(e).__name__}")


def _sig(e: Expr) -> str:
    """Canonical structural signature of an expression (literal *values*
    included except where a ``ParamRef`` already abstracted them); the
    reference's string, character for character."""
    if isinstance(e, ParamRef):
        return f"par{e.idx}:{e.dtype.name}"
    if isinstance(e, ColumnRef):
        return f"col({e.name})"
    if isinstance(e, Literal):
        return f"lit({e.value!r}:{e.dtype.name})"
    if isinstance(e, BinaryOp):
        return f"({_sig(e.lhs)} {e.op} {_sig(e.rhs)})"
    if isinstance(e, UnaryOp):
        return f"{e.op}({_sig(e.operand)})"
    if isinstance(e, IsIn):
        return f"isin({_sig(e.operand)},{e.values!r})"
    if isinstance(e, BytesMatch):
        return f"match({_sig(e.operand)},{e.parts!r},{e.mode})"
    if isinstance(e, Year):
        return f"year({_sig(e.operand)})"
    if isinstance(e, PrefixCode):
        return f"pfx({_sig(e.operand)},{e.n})"
    raise Ineligible(f"unsupported expression {type(e).__name__}")


# ---------------------------------------------------------------------------
# shape extraction + program interning
# ---------------------------------------------------------------------------

class BatchProgram:
    """One interned stacked-execution template, shared by every query whose
    optimized plan has the same structural signature. Hashes by identity:
    the interning table guarantees that signature-equal queries get the
    *same* object, so the lowered programs cached on it serve every
    member, batch and submission."""

    def __init__(self, sig: str, table: str, columns, pre_stages,
                 param_dtypes, group_keys, user_specs, max_groups,
                 post_stages):
        self.sig = sig
        self.table = table
        self.columns = tuple(columns) if columns is not None else None
        # pre-aggregation stages in ``fused.Stage`` form; filter exprs are
        # parameterized templates, projections are shared verbatim
        self.pre_stages: Tuple[fused.Stage, ...] = tuple(pre_stages)
        self.param_dtypes: Tuple[dt.DType, ...] = tuple(param_dtypes)
        self.group_keys: Tuple[str, ...] = tuple(group_keys)
        self.user_specs = tuple(user_specs)      # as written (avg intact)
        self.lowered_specs = lower_aggs(self.user_specs)  # avg -> sum+cnt
        self.max_groups = int(max_groups)
        self.has_agg = bool(user_specs) or bool(group_keys)
        # stages above the aggregation (final projection, HAVING); applied
        # per member on its [max_groups]-row result slice
        self.post_stages: Tuple[fused.Stage, ...] = tuple(post_stages)
        # input signature -> fused.Program (the lane count is a launch
        # argument); scheduler workers lower concurrently, so writes take
        # the lock
        self._lowered: Dict[tuple, fused.Program] = {}
        self._lock = threading.Lock()

    def lowered(self, table: TorchTable) -> fused.Program:
        """The register program of ``pre_stages`` over ``table``'s columns,
        lowered once and cached; it serves every lane count."""
        key = tuple((n, a.dtype, tuple(a.shape[1:]))
                    for n, a in table.columns.items())
        program = self._lowered.get(key)
        if program is None:
            with self._lock:
                program = self._lowered.get(key)
                if program is None:
                    program = fused.lower_stages(table, self.pre_stages,
                                                 batch=True)
                    self._lowered[key] = program
        return program

    def __repr__(self):
        return f"BatchProgram({self.table}, {self.sig[:60]}...)"


@dataclasses.dataclass(eq=False)
class BatchShape:
    """One query's membership ticket: the interned program plus the
    member's literal values for the program's parameter slots."""

    program: BatchProgram
    params: Tuple


_PROGRAMS: Dict[str, BatchProgram] = {}
_PROGRAMS_LOCK = threading.Lock()


def clear_programs() -> None:
    """Drop the interned-program table (test isolation)."""
    with _PROGRAMS_LOCK:
        _PROGRAMS.clear()


def extract_shape(plan: P.PlanNode) -> Optional[BatchShape]:
    """Lift an optimized plan into a ``BatchShape``, or None if ineligible.

    Eligible plans are a linear single-table chain::

        TableScan[filter?] -> {Filter|Project}* -> Aggregation?
                           -> {Filter|Project}*   (post-agg stages)

    with at most one Aggregation (mode auto/single, kinds
    sum/count/min/max/avg) and expressions drawn from the core Expr
    algebra. Joins, sorts, limits, distinct, exchanges, and multi-phase
    aggregations stay on the solo path. Only *filter* literals below the
    aggregation are parameterized; projection and post-aggregation
    literals are shared computation and join the signature by value.
    """
    try:
        return _extract(plan)
    except Ineligible:
        return None


def _extract(plan: P.PlanNode) -> BatchShape:
    nodes: List[P.PlanNode] = []
    node = plan
    while not isinstance(node, P.TableScan):
        if isinstance(node, (P.Filter, P.Project, P.Aggregation)):
            nodes.append(node)
            node = node.child
        else:
            raise Ineligible(type(node).__name__)
    scan = node
    nodes.reverse()                       # scan-first order

    aggs = [n for n in nodes if isinstance(n, P.Aggregation)]
    if len(aggs) > 1:
        raise Ineligible("stacked aggregations")
    agg = aggs[0] if aggs else None
    if agg is not None:
        if agg.mode not in ("auto", "single"):
            raise Ineligible(f"aggregation mode {agg.mode}")
        for _out, kind, _col in agg.aggs:
            if kind not in _AGG_KINDS:
                raise Ineligible(f"aggregation kind {kind}")
    split = nodes.index(agg) if agg is not None else len(nodes)
    below = nodes[:split]
    above = nodes[split + 1:] if agg is not None else []

    param_dtypes: list = []
    param_values: list = []
    columns = tuple(scan.columns) if scan.columns is not None else None
    sig_parts = [f"scan({scan.table};{columns})"]
    pre: List[fused.Stage] = []
    # the pushed-down scan filter re-applies as the first parameterized
    # stage: the batched scan streams unfiltered (members' predicates
    # differ)
    for filt in ([scan.filter] if scan.filter is not None else []):
        tmpl = _parameterize(filt, param_dtypes, param_values)
        pre.append((tmpl, None))
        sig_parts.append(f"f[{_sig(tmpl)}]")
    for n in below:
        if isinstance(n, P.Filter):
            tmpl = _parameterize(n.predicate, param_dtypes, param_values)
            pre.append((tmpl, None))
            sig_parts.append(f"f[{_sig(tmpl)}]")
        else:
            projs = tuple((name, e) for name, e in n.projections)
            pre.append((None, projs))
            sig_parts.append(
                "p[" + ",".join(f"{nm}={_sig(e)}" for nm, e in projs) + "]")

    group_keys: Tuple[str, ...] = ()
    user_specs: tuple = ()
    max_groups = 1
    if agg is not None:
        group_keys = tuple(agg.group_keys)
        user_specs = tuple((o, k, c) for o, k, c in agg.aggs)
        max_groups = int(agg.max_groups)
        sig_parts.append(
            f"agg[{group_keys};"
            + ",".join(f"{o}:{k}:{c}" for o, k, c in user_specs)
            + f";{max_groups}]")

    post: List[fused.Stage] = []
    for n in above:
        if isinstance(n, P.Filter):
            post.append((n.predicate, None))
            sig_parts.append(f"F[{_sig(n.predicate)}]")
        else:
            projs = tuple((name, e) for name, e in n.projections)
            post.append((None, projs))
            sig_parts.append(
                "P[" + ",".join(f"{nm}={_sig(e)}" for nm, e in projs) + "]")

    sig = "|".join(sig_parts)
    with _PROGRAMS_LOCK:
        program = _PROGRAMS.get(sig)
        if program is None:
            program = BatchProgram(sig, scan.table, columns, pre,
                                   param_dtypes, group_keys, user_specs,
                                   max_groups, post)
            _PROGRAMS[sig] = program
    return BatchShape(program, tuple(param_values))


# ---------------------------------------------------------------------------
# batched per-morsel evaluation
# ---------------------------------------------------------------------------

@table_op
def batch_morsel_op(program: BatchProgram, n_members: int,
                    table: TorchTable, params: Tuple):
    """Run one morsel through the batched stage program: one
    ``fused_batch_program`` launch on the card, with the program lowered
    once per input signature; dispatch accounting counts the kind
    ``fused_batch`` once per morsel, as the reference's
    ``batch_morsel_op`` does."""
    lowered = program.lowered(table) if table.validity.is_cuda else None
    return fused.fused_batch_program(table, program.pre_stages, params,
                                     n_members, program=lowered)


# ---------------------------------------------------------------------------
# stacked aggregation
# ---------------------------------------------------------------------------

def _stacked_segment_agg(vals, member_sorted, gids, max_groups: int,
                         n_members: int, kind: str):
    """All members' segmented aggregation of one spec in one kernel call.

    ``vals`` are the shared values in union-sorted row order,
    ``member_sorted`` the per-member validity ``[B, n]`` in the same
    order, ``gids`` the shared dense group ids (union-invalid rows carry
    ``max_groups``). Member ``b``'s group ``j`` maps to stacked segment
    ``b * max_groups + j``; rows dead for a member map to the ``B *
    max_groups`` sentinel, which the kernels drop -- the only rows whose
    gid is the ``max_groups`` sentinel are union-invalid, hence dead for
    every member, so no remap aliases a neighbour lane's group 0. The
    stacked ids are NOT sorted (a union-valid, member-dead row interrupts
    a run); the CUDA kernels fold runs of equal neighbours and add with
    atomics, so any order is right. Returns ``[B, max_groups]``.

    The reference's kernel branch, always: ``segmented_int_sum`` for
    counts and integer sums, ``segmented_sum`` for float sums and
    ``segmented_minmax`` for min and max (its one-hot ``dot_general`` and
    ``jax.ops.segment_*`` branches are non-kernel paths the port does not
    have)."""
    total = n_members * max_groups
    n = member_sorted.shape[1]
    dev = member_sorted.device
    lane = max_groups * torch.arange(n_members, dtype=torch.int32,
                                     device=dev)[:, None]
    seg = torch.where(member_sorted, gids[None, :] + lane,
                      torch.tensor(total, dtype=torch.int32, device=dev))
    seg = seg.reshape(-1).to(torch.int32)
    mflat = member_sorted.reshape(-1)
    kernel_ops.mark_kernel("agg")
    if kind == "count":
        out = segmented_agg.segmented_int_sum(seg, mflat.to(torch.int32),
                                              total)
        return out.reshape(n_members, max_groups)
    if kind not in ("sum", "min", "max"):
        raise ValueError(f"_stacked_segment_agg: kind {kind!r}")
    if vals.dim() != 1 or vals.dtype not in (torch.int32, torch.float32):
        raise NotImplementedError(
            f"stacked {kind} over {vals.dtype} {tuple(vals.shape)}")
    vflat = vals[None, :].expand(n_members, n).reshape(-1)
    if kind == "sum":
        # zero dead rows: their values may be NaN/inf (dead-lane arithmetic)
        acc = torch.where(mflat, vflat, torch.zeros((), dtype=vals.dtype,
                                                    device=dev))
        if vals.dtype == torch.int32:
            out = segmented_agg.segmented_int_sum(seg, acc, total)
        else:
            out = segmented_agg.segmented_sum(seg, acc, total)
    else:
        ident = rel._extreme(vals.dtype, 1 if kind == "min" else -1).to(dev)
        out = segmented_agg.segmented_minmax(
            seg, torch.where(mflat, vflat, ident), total, kind)
    return out.reshape(n_members, max_groups)


def _stacked_aggregate(table: TorchTable, masks, program: BatchProgram,
                       n_members: int):
    """All members' aggregation over the materialized batched output.

    Keyed: ONE ``group_rows`` over the union of member masks (members
    share key columns, so their groups are a subsequence of the union's
    ascending group order -- matching solo output order), then every spec
    through the stacked segmented aggregation. Global: masked reductions
    per member lane. avg finalizes as sum/max(count,1) exactly like
    ``operators._finalize_avg``. Returns ``(key columns [max_groups],
    agg columns [B, max_groups], emission mask [B, max_groups])``."""
    G = program.max_groups
    dev = table.device
    key_vals: Dict[str, torch.Tensor] = {}
    agg_cols: Dict[str, torch.Tensor] = {}
    zeros = torch.zeros(table.capacity, dtype=torch.int32, device=dev)
    if program.group_keys:
        key_cols = [table.columns[k] for k in program.group_keys]
        union = masks.any(dim=0)
        g = rel.group_rows(key_cols, union, G)
        order = g.order.long()
        member_sorted = masks.index_select(1, order)
        key_rows = g.key_rows.long()
        for k in program.group_keys:
            key_vals[k] = table.columns[k].index_select(0, key_rows)
        rows = _stacked_segment_agg(zeros, member_sorted, g.gids, G,
                                    n_members, "count")
        emit = g.group_valid[None, :] & (rows > 0)
        for out, kind, col_ in program.lowered_specs:
            vals = zeros if col_ is None else table.columns[col_]
            agg_cols[out] = _stacked_segment_agg(
                vals.index_select(0, order), member_sorted, g.gids, G,
                n_members, kind)
    else:
        # global aggregation: one row per member, masked reductions (the
        # identities of operators._aggregate's keyless branch)
        emit = torch.ones((n_members, 1), dtype=torch.bool, device=dev)
        for out, kind, col_ in program.lowered_specs:
            vals = zeros if col_ is None else table.columns[col_]
            if kind == "count":
                agg_cols[out] = masks.sum(dim=1, dtype=torch.int32,
                                          keepdim=True)
                continue
            if vals.dim() != 1:
                raise NotImplementedError(
                    f"stacked {kind} over {vals.dtype} {tuple(vals.shape)}")
            if kind == "sum":
                fill = torch.zeros((), dtype=vals.dtype, device=dev)
                agg_cols[out] = torch.where(masks, vals[None], fill).sum(
                    dim=1, dtype=vals.dtype, keepdim=True)
            elif kind == "min":
                fill = rel._extreme(vals.dtype, 1).to(dev)
                agg_cols[out] = torch.where(masks, vals[None], fill).amin(
                    dim=1, keepdim=True)
            elif kind == "max":
                fill = rel._extreme(vals.dtype, -1).to(dev)
                agg_cols[out] = torch.where(masks, vals[None], fill).amax(
                    dim=1, keepdim=True)
            else:
                raise ValueError(kind)
    # finalize avg lanes (same arithmetic as operators._finalize_avg)
    for out, kind, _col in program.user_specs:
        if kind == "avg":
            s = agg_cols.pop(f"{out}__sum")
            c = agg_cols.pop(f"{out}__cnt")
            agg_cols[out] = (s.to(torch.float32)
                             / torch.clamp(c, min=1).to(torch.float32))
    return key_vals, agg_cols, emit


_stacked_aggregate_op = table_op(_stacked_aggregate)


@table_op
def _post_op(table: TorchTable, stages):
    return fused.apply_stages(table, stages)


def _agg_schema(program: BatchProgram, in_schema) -> Dict[str, dt.DType]:
    """Host-side output schema of the stacked aggregation (same rules as
    ``operators._aggregate`` + avg finalize)."""
    schema: Dict[str, dt.DType] = {}
    for k in program.group_keys:
        schema[k] = in_schema[k]
    for out, kind, col_ in program.user_specs:
        if kind == "avg":
            schema[out] = dt.FLOAT32
        elif kind == "count":
            schema[out] = dt.INT32
        else:
            schema[out] = in_schema[col_]
    return schema


# ---------------------------------------------------------------------------
# batched execution loop (called from Driver.collect_batch)
# ---------------------------------------------------------------------------

def padded_members(n: int) -> int:
    """Member-lane count rounded up to a power of two: dummy lanes reuse
    member 0's parameters and have their outputs dropped, so one lowered
    program per (program, lane count) serves every batch size beneath
    it."""
    return 1 << max(0, (n - 1).bit_length())


def _params(program: BatchProgram, shapes: Sequence[BatchShape], lanes: int,
            device: torch.device) -> Tuple[torch.Tensor, ...]:
    """One ``[lanes]`` tensor per parameter slot on ``device``; dummy
    lanes repeat member 0's values."""
    n = len(shapes)
    out = []
    for i, d in enumerate(program.param_dtypes):
        host = np.asarray([s.params[i] for s in shapes]
                          + [shapes[0].params[i]] * (lanes - n),
                          dtype=d.np_dtype())
        out.append(torch.from_numpy(host).to(device, d.torch_dtype()))
    return tuple(out)


def run_batch(driver, shapes: Sequence[BatchShape],
              lanes: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """Execute ``shapes`` (all sharing one interned program) as a single
    stacked scan; returns one host-numpy result dict per member, in
    order. The caller (``Driver.collect_batch``) provides the dispatch
    scope and holds W = 1 (on a mesh session the mesh is one card).
    ``lanes`` pins the stacked lane count (it must cover the group); by
    default it is the group's size rounded up to a power of two."""
    program = shapes[0].program
    if any(s.program is not program for s in shapes):
        raise ValueError("run_batch members must share one interned "
                         "BatchProgram")
    n = len(shapes)
    lanes = padded_members(max(n, lanes or 0))
    ctx = driver.ctx
    params = _params(program, shapes, lanes, ctx.device)
    src = ctx.catalog.get(program.table)
    stats = driver.scan_stats.setdefault(program.table, ScanStats())
    columns = list(program.columns) if program.columns is not None else None
    # the scan reads unfiltered: member predicates differ, so zone-map
    # skipping is off and each pushed-down filter re-applies as that
    # member's first parameterized stage (a superset scan is always safe)
    # batching is W = 1 only: on a mesh that is a one-card mesh (a mesh of
    # several cards cannot hold one worker), whose card is ctx.device
    if ctx.streaming:
        morsels = src.stream(columns, ctx.batch_rows, ctx.device,
                             prefetch_depth=ctx.prefetch_depth, stats=stats,
                             **driver._on_mesh())
    else:
        morsels = src.scan(columns, ctx.batch_rows, ctx.device, stats=stats,
                           **driver._on_mesh())

    spent = 0.0
    if program.has_agg:
        tables: List[TorchTable] = []
        mask_parts: List[torch.Tensor] = []
        for step in morsels:
            t0 = time.perf_counter()
            out_table, masks = batch_morsel_op(program, lanes, step[0],
                                               params)
            spent += time.perf_counter() - t0
            tables.append(out_table)
            mask_parts.append(masks)
        t0 = time.perf_counter()
        # small-query contract: the projected scan output materializes on
        # the device (like any blocking aggregation input) and aggregates
        # once
        table = concat_tables(tables)
        masks = (mask_parts[0] if len(mask_parts) == 1
                 else torch.cat(mask_parts, dim=1))
        key_vals, agg_cols, emit = _stacked_aggregate_op(table, masks,
                                                         program, lanes)
        schema = _agg_schema(program, table.schema)
        results: List[Dict[str, np.ndarray]] = []
        for b in range(n):
            cols = {k: key_vals[k] for k in program.group_keys}
            for out, _kind, _col in program.user_specs:
                cols[out] = agg_cols[out][b]
            member = TorchTable(cols, emit[b], dict(schema))
            if program.post_stages:
                member = _post_op(member, program.post_stages)
            results.append(member.to_numpy())
        spent += time.perf_counter() - t0
        driver.op_seconds["BatchedPipeline"] = (
            driver.op_seconds.get("BatchedPipeline", 0.0) + spent)
        return results

    # row queries: per-morsel host scatter in morsel order -- the solo
    # path's row order (valid rows in morsel order)
    acc: List[Dict[str, List[np.ndarray]]] = [{} for _ in range(n)]
    out_names: List[str] = []
    for step in morsels:
        t0 = time.perf_counter()
        out_table, masks = batch_morsel_op(program, lanes, step[0], params)
        spent += time.perf_counter() - t0
        out_names = list(out_table.column_names)
        masks_np = masks[:n].cpu().numpy()
        cols_np = {c: out_table.columns[c].cpu().numpy() for c in out_names}
        for b in range(n):
            sel = masks_np[b]
            for c in out_names:
                acc[b].setdefault(c, []).append(cols_np[c][sel])
    driver.op_seconds["BatchedPipeline"] = (
        driver.op_seconds.get("BatchedPipeline", 0.0) + spent)
    return [{c: np.concatenate(parts[c]) for c in out_names}
            for parts in acc]
