"""Query driver (the port of ``repro.core.driver``), one worker.

``Driver`` walks a logical plan and streams batches through device
operators. Scans run as ``StreamingScan`` stages fed by a
``MorselPrefetcher``; Filter and Project nodes above a scan fuse into its
per-morsel pipeline, which ``operators.fuse_morsel_pipeline`` collapses
into one fused kernel launch per morsel.

The port runs TableScan, Filter (``compact=True`` stream-compacts the
survivors), Project, Aggregation, Distinct, Join (hash joins; a
single-match probe straight off a scan fuses into the scan's morsel
pipeline), ScalarBroadcast, OrderBy and Limit at ``num_workers == 1``.
Any other node raises ``NotImplementedError`` naming the slice that brings
it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from . import operators as ops
from . import plan as P
from .streaming import ScanStats
from .table import TorchTable, concat_tables

# node type -> the port slice that brings it (ROADMAP.md, queue A)
_LATER = {
    "InMemorySource": "the SQL frontend slice",
    "Exchange": "the distributed slice",
    "Repartition": "the distributed slice",
    "Broadcast": "the distributed slice",
}


@dataclasses.dataclass
class ExecutionContext:
    """Per-query execution config snapshot from a ``Session``."""

    catalog: "object"                       # repro_torch.core.session.Catalog
    device: torch.device
    num_workers: int = 1
    batch_rows: int = 8192
    prefetch_depth: int = 2


@dataclasses.dataclass
class Stream:
    """A stage output. ``scan`` is set while the stream is still the raw
    output of a ``StreamingScan``: Filter/Project nodes fuse into it."""

    batches: Iterator[TorchTable]
    scan: Optional["StreamingScan"] = None


class StreamingScan:
    """Morsel-driven scan stage: drains the prefetch queue and runs the
    scan-fused operator pipeline on each morsel as it arrives."""

    def __init__(self, table: str, morsels: Iterator[TorchTable],
                 stats: ScanStats, op_seconds: Dict[str, float]):
        self.table = table
        self.morsels = morsels
        self.stats = stats
        self.pipe = ops.Pipeline()
        self._op_seconds = op_seconds

    def fuse(self, op: ops.Operator) -> None:
        """Append an operator to the per-morsel pipeline (before iteration)."""
        self.pipe.ops.append(op)

    def batches(self) -> Iterator[TorchTable]:
        """Drain the prefetch queue through the fused per-morsel pipeline."""
        spent = 0.0
        ops.fuse_morsel_pipeline(self.pipe)
        self.pipe.open()
        for morsel in self.morsels:
            t0 = time.perf_counter()
            outs = self.pipe.add_input(morsel)
            spent += time.perf_counter() - t0
            yield from outs
        t0 = time.perf_counter()
        outs = self.pipe.finish()
        spent += time.perf_counter() - t0
        self._op_seconds["StreamingScan"] = (
            self._op_seconds.get("StreamingScan", 0.0) + spent)
        yield from outs


class Driver:
    """Executes one logical plan as streaming operator pipelines; one
    instance per query."""

    def __init__(self, ctx: ExecutionContext):
        if ctx.num_workers != 1:
            raise NotImplementedError(
                f"repro_torch runs one worker; num_workers={ctx.num_workers} "
                "comes with the distributed slice")
        self.ctx = ctx
        self.op_seconds: Dict[str, float] = {}
        self.scan_stats: Dict[str, ScanStats] = {}
        # kind -> operator calls that used a kernel of that kind
        self.kernel_dispatch: Dict[str, int] = {}

    def executor_stats(self) -> Dict[str, object]:
        """Per-query stats: scan counters, operator seconds, the device,
        and kernel dispatch counts (comparable with the reference's
        ``pallas`` run)."""
        return {
            "tables": {t: s.summary() for t, s in self.scan_stats.items()},
            "op_seconds": dict(self.op_seconds),
            "device": str(self.ctx.device),
            "kernel_dispatch": dict(self.kernel_dispatch),
        }

    # -- public API ----------------------------------------------------------
    def execute(self, node: P.PlanNode) -> TorchTable:
        """Run the plan; return the result as one device-resident table."""
        with kernel_ops.collect_dispatches(self.kernel_dispatch):
            return self._materialize(self._stream(node).batches)

    def collect(self, node: P.PlanNode) -> Dict[str, np.ndarray]:
        """Run the plan; return valid rows as host numpy columns."""
        return self.execute(node).to_numpy()

    # -- plumbing --------------------------------------------------------------
    def _materialize(self, batches: Iterator[TorchTable]) -> TorchTable:
        got = list(batches)
        assert got, "empty stream"
        return concat_tables(got)

    def _run_pipeline(self, op: ops.Operator, stream: Iterator[TorchTable]
                      ) -> Iterator[TorchTable]:
        t0 = time.perf_counter()
        op.open()
        for batch in stream:
            yield from op.add_input(batch)
        yield from op.finish()
        self.op_seconds[op.name] = (self.op_seconds.get(op.name, 0.0)
                                    + time.perf_counter() - t0)

    # -- recursive plan execution ----------------------------------------------
    def _stream(self, node: P.PlanNode) -> Stream:
        name = type(node).__name__
        method = getattr(self, f"_exec_{name.lower()}", None)
        if method is None:
            raise NotImplementedError(
                f"repro_torch: {name} comes with "
                f"{_LATER.get(name, 'a later slice')}")
        return method(node)

    def _exec_tablescan(self, node: P.TableScan) -> Stream:
        src = self.ctx.catalog.get(node.table)
        stats = self.scan_stats.setdefault(node.table, ScanStats())
        morsels = src.stream(node.columns, self.ctx.batch_rows,
                             self.ctx.device,
                             prefetch_depth=self.ctx.prefetch_depth,
                             stats=stats)
        scan = StreamingScan(node.table, morsels, stats, self.op_seconds)
        if node.filter is not None:
            scan.fuse(ops.FilterProject(node.filter))
        return Stream(scan.batches(), scan=scan)

    def _exec_filter(self, node: P.Filter) -> Stream:
        child = self._stream(node.child)
        fp = ops.FilterProject(node.predicate, None, node.compact)
        if child.scan is not None:
            child.scan.fuse(fp)          # per-morsel, inside the scan stage
            return child
        return Stream(self._run_pipeline(fp, child.batches))

    def _exec_project(self, node: P.Project) -> Stream:
        child = self._stream(node.child)
        fp = ops.FilterProject(None, node.projections)
        if child.scan is not None:
            child.scan.fuse(fp)          # per-morsel, inside the scan stage
            return child
        return Stream(self._run_pipeline(fp, child.batches))

    def _exec_aggregation(self, node: P.Aggregation) -> Stream:
        child = self._stream(node.child)
        mode = "single" if node.mode == "auto" else node.mode
        agg = ops.HashAggregation(node.group_keys, node.aggs, mode,
                                  node.max_groups)
        return Stream(self._run_pipeline(agg, child.batches))

    def _exec_distinct(self, node: P.Distinct) -> Stream:
        child = self._stream(node.child)
        d = ops.Distinct(node.keys, node.max_groups)
        return Stream(self._run_pipeline(d, child.batches))

    def _exec_scalarbroadcast(self, node: P.ScalarBroadcast) -> Stream:
        # the scalar side runs to its end first, as in the reference
        scalar = self._materialize(self._stream(node.scalar).batches)
        child = self._stream(node.child)
        sb = ops.ScalarBroadcast(node.columns)
        sb.set_scalar(scalar)
        return Stream(self._run_pipeline(sb, child.batches))

    def _exec_join(self, node: P.Join) -> Stream:
        build = self._materialize(self._stream(node.build).batches)
        probe = self._stream(node.probe)
        join = ops.HashJoin(node.build_keys, node.probe_keys,
                            node.build_payload, node.join_type,
                            node.max_matches, build_rows=node.build_rows)
        join.open()
        join.add_build(build)
        join.seal_build()
        if probe.scan is not None and not join._multi:
            # fuse the probe into the scan's per-morsel pipeline, where the
            # iteration-start collapse folds it and the stages before it
            # into one fused launch per morsel; the join's time folds into
            # the StreamingScan entry of op_seconds, and the returned stream
            # drops the scan so later stages keep their own launches
            probe.scan.fuse(join)
            return Stream(probe.batches)
        return Stream(self._run_pipeline(join, probe.batches))

    def _exec_orderby(self, node: P.OrderBy) -> Stream:
        child = self._stream(node.child)
        # compact away dead padding (e.g. max_groups slots) before sorting
        table = ops.maybe_compact(self._materialize(child.batches))
        ob = ops.OrderBy(node.keys, node.descending, node.limit)
        return Stream(self._run_pipeline(ob, iter([table])))

    def _exec_limit(self, node: P.Limit) -> Stream:
        child = self._stream(node.child)
        table = self._materialize(child.batches)
        return Stream(self._run_pipeline(ops.Limit(node.n), iter([table])))
