"""Query driver (the port of ``repro.core.driver``).

``Driver`` walks a logical plan and streams batches through device
operators. Scans run as ``StreamingScan`` stages fed by a
``MorselPrefetcher``; Filter and Project nodes above a scan fuse into its
per-morsel pipeline, which ``operators.fuse_morsel_pipeline`` collapses
into one fused kernel launch per morsel.

W workers run one driver each, as in Presto: a stage's stream advances
all workers in lockstep, each step holding one batch per worker (the
reference's ``[W, cap]`` batch as a list), and every worker has its own
operator instances -- its own scan pipeline, hash-join build table and
aggregation state, as the reference's ``vmap`` gives each worker slice.
Off the mesh every worker is on the context's device. On a mesh
(``ExecutionContext.mesh``, a ``launch.mesh.EngineMesh``) worker w's scan
output lands on ``worker_device(w)``, its operators allocate on the device
of their input, so every kernel of that worker launches there, and only
the exchanges move rows between devices. Exchanges (``core.exchange``)
move rows between the workers' tables at ``Repartition``/``Broadcast``
nodes, two-phase aggregations, and the gathers before a global sort,
limit or scalar subquery. At W = 1 every
stream is a list of one and no exchange runs.

The port runs TableScan, InMemorySource, Filter (``compact=True``
stream-compacts the survivors), Project, Aggregation, Distinct, Join (hash
joins; a single-match probe straight off a scan fuses into the scan's
morsel pipeline), ScalarBroadcast, OrderBy, Limit, Exchange, Repartition
and Broadcast.

Out of core (``ExecutionContext.spill``, a ``core.spill.SpillManager``
with one device budget for the query over all its workers and devices):
a join whose build side does not fit its device reservation runs as one
``GraceHashJoin`` over the workers' steps, an aggregation whose
accumulator does not fit flushes runs to the host tier, an exchange send
buffer past the unreserved budget is staged through the spill store, and
every scan's prefetcher draws on the manager's host budget. A spilled
partition comes back on the device it left, so on a mesh each worker's
state stays on its own card.

Runtime feedback (``ExecutionContext.feedback``, a
``core.feedback.FeedbackStore``): every plan node's stream but the
exchanges' is wrapped in counters, an int64 tensor a worker on that
worker's device, that each step adds the worker's valid rows to; a join's
exact-key build multiplicity is computed on the device too (a sort and run
lengths, on worker 0's device). Nothing is read back until
``_harvest_feedback`` reads every count in one transfer, once per query,
after the result is ready, and records them in the store. As in the
reference, a scan counts the rows left after the Filter, Project and
single-match probe fused into it. With no store nothing is wrapped.

``collect_batch`` runs a group of compatible small queries as one stacked
scan (``core.batch``); the scheduler calls it for inter-query batching. It
never harvests: the scheduler batches no query that has a store.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from . import operators as ops
from . import plan as P
from .exchange import ExchangeProtocol, ICIExchange, maybe_compact
from .streaming import ScanStats
from .table import TorchTable, concat_tables

# one batch per worker
Step = List[TorchTable]

# smallest device reservation granted to a memory-hungry operator under
# pressure: enough to make progress (one partition / a few groups resident)
# without letting small operators monopolise the budget
_MIN_GRANT = 1 << 10


@dataclasses.dataclass
class ExecutionContext:
    """Per-query execution config snapshot from a ``Session``."""

    catalog: "object"                       # repro_torch.core.session.Catalog
    device: torch.device
    num_workers: int = 1
    exchange: Optional[ExchangeProtocol] = None
    batch_rows: int = 8192
    prefetch_depth: int = 2
    # morsel-driven scans with prefetch (False = the synchronous baseline)
    streaming: bool = True
    # operators whose device version is "unavailable" (host round trip)
    host_only_ops: frozenset = frozenset()
    # tiered-memory spill manager (core.spill). None = in-memory-only
    # execution; set, joins whose build side exceeds its reservation go
    # grace-partitioned, aggregations flush accumulator runs to the host
    # tier, and oversized exchange send buffers stage through the store
    spill: Optional[object] = None
    # runtime-feedback store (core.feedback.FeedbackStore). Set, the driver
    # counts each plan node's valid output rows on the device while
    # streaming and harvests the counts (plus join build-key multiplicities
    # and zone-map skip fractions) into the store after the query
    # completes, so the next optimization of the same plan shape re-plans
    # warm
    feedback: Optional[object] = None
    # the worker mesh (launch.mesh.EngineMesh): worker w's tables live on
    # mesh.device_of(w, num_workers). None = every worker on ``device``
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.exchange is None:
            self.exchange = ICIExchange(mesh=self.mesh)

    def host_budget(self):
        """Shared host-memory budget (prefetch + spill host tier), if any."""
        return self.spill.host if self.spill is not None else None

    def worker_device(self, w: int) -> torch.device:
        """The device of worker ``w``: its mesh device, else ``device``."""
        if self.mesh is None:
            return self.device
        return self.mesh.device_of(w, self.num_workers)


@dataclasses.dataclass
class Stream:
    """A stage output: an iterator of steps (one batch per worker) and the
    distribution of its rows, ``'partitioned'`` or ``'replicated'``.
    ``scans`` is set while the stream is still the raw output of the
    workers' ``StreamingScan``s: Filter/Project nodes fuse into them."""

    batches: Iterator[Step]
    dist: str = "partitioned"
    scans: Optional[List["StreamingScan"]] = None


class StreamingScan:
    """One worker's morsel-driven scan stage: runs its scan-fused operator
    pipeline on each of its morsels as the prefetch queue delivers them."""

    def __init__(self, table: str):
        self.table = table
        self.pipe = ops.Pipeline()

    def fuse(self, op: ops.Operator) -> None:
        """Append an operator to the per-morsel pipeline (before iteration)."""
        self.pipe.ops.append(op)


def _lockstep(outs: Sequence[List[TorchTable]]) -> Iterator[Step]:
    """The workers' outputs for one input step, regrouped into steps."""
    if len({len(o) for o in outs}) > 1:
        raise RuntimeError(f"workers produced {[len(o) for o in outs]} "
                           "batches for one step")
    return (list(step) for step in zip(*outs))


def empty_executor_stats() -> Dict[str, object]:
    """The executor-stats dict shape before any query has run (the keys
    of ``Driver.executor_stats``, empty), so a caller can index
    ``stats['kernel_dispatch']`` before a scheduled query has run."""
    return {
        "tables": {},
        "op_seconds": {},
        "conversions": {},
        "device": "",
        "worker_devices": [],
        "kernel_dispatch": {},
        "exchange_protocol": "",
        "exchanges": {},
        "spill": {},
        "spill_staged_exchanges": 0,
        "feedback": {},
    }


class Driver:
    """Executes one logical plan as streaming operator pipelines; one
    instance per query (or per stacked batch of queries)."""

    def __init__(self, ctx: ExecutionContext):
        self.ctx = ctx
        self.op_seconds: Dict[str, float] = {}
        # bytes through the host round trips of host-only operators
        self.conversion_stats: Dict[str, int] = {}
        self.scan_stats: Dict[str, ScanStats] = {}
        # kind -> operator calls that used a kernel of that kind
        self.kernel_dispatch: Dict[str, int] = {}
        # per-fragment exchange stats, in execution order
        # ("#0 Repartition(l_orderkey)" -> counter deltas)
        self.exchange_stats: Dict[str, Dict[str, float]] = {}
        self._frag_seq = 0
        # exchanges whose send buffer was staged through the spill store
        self.spill_staged_exchanges = 0
        self._spill_seq = 0
        # runtime-feedback observations, all device tensors until the
        # harvest: (node, int64 row counter, distribution) per observed
        # node and worker (W entries a node, worker 0's first, each counter
        # on its worker's device), and id(join node) -> exact-key build
        # multiplicity
        self._feedback_obs: list = []
        self._feedback_matches: Dict[int, torch.Tensor] = {}

    def executor_stats(self) -> Dict[str, object]:
        """Per-query stats: scan counters, operator seconds, the device and
        each worker's device, kernel dispatch counts (comparable with the
        reference's ``pallas`` run), the exchange protocol, per-fragment
        exchange counters, the per-tier spill counters, and the
        feedback-store summary."""
        return {
            "tables": {t: s.summary() for t, s in self.scan_stats.items()},
            "op_seconds": dict(self.op_seconds),
            "conversions": dict(self.conversion_stats),
            "device": str(self.ctx.device),
            "worker_devices": [str(self.ctx.worker_device(w))
                               for w in range(self._w)],
            "kernel_dispatch": dict(self.kernel_dispatch),
            "exchange_protocol": self.ctx.exchange.name,
            "exchanges": {k: dict(v) for k, v in self.exchange_stats.items()},
            "spill": (self.ctx.spill.stats.summary()
                      if self.ctx.spill is not None else {}),
            "spill_staged_exchanges": self.spill_staged_exchanges,
            "feedback": (self.ctx.feedback.summary()
                         if self.ctx.feedback is not None else {}),
        }

    # -- public API ----------------------------------------------------------
    def execute(self, node: P.PlanNode) -> List[TorchTable]:
        """Run the plan; return the result as one device-resident table per
        worker."""
        return self._run(node)[1]

    def collect(self, node: P.PlanNode) -> Dict[str, np.ndarray]:
        """Run the plan; return valid rows as host numpy columns (worker 0's
        for a replicated result, every worker's in order otherwise)."""
        stream, tables = self._run(node)
        if stream.dist == "replicated":
            return tables[0].to_numpy()
        parts = [t.to_numpy() for t in tables]
        return {n: np.concatenate([p[n] for p in parts]) for n in parts[0]}

    def collect_batch(self, shapes, lanes: Optional[int] = None) -> list:
        """Run a group of compatible queries (``core.batch.BatchShape``s
        sharing one interned program) as a single stacked execution;
        returns one host-numpy result dict per member, in order. ``lanes``
        pins the member-lane count of the stacked program; None sizes it
        to the group. Batching is W = 1 only, and records no feedback."""
        from . import batch   # batch imports operators and fused
        try:
            if self._w != 1:
                raise ValueError(f"collect_batch: batching runs at W = 1, "
                                 f"not W = {self._w}")
            with kernel_ops.collect_dispatches(self.kernel_dispatch):
                return batch.run_batch(self, shapes, lanes=lanes)
        finally:
            self._close_spill()

    def _run(self, node: P.PlanNode):
        try:
            with kernel_ops.collect_dispatches(self.kernel_dispatch):
                stream = self._stream(node)
                tables = self._materialize(stream.batches)
            self._harvest_feedback()
            return stream, tables
        finally:
            self._close_spill()

    def _close_spill(self) -> None:
        """Delete this query's spill files (counters survive in stats)."""
        if self.ctx.spill is not None:
            self.ctx.spill.close()

    # -- plumbing --------------------------------------------------------------
    @property
    def _w(self) -> int:
        return self.ctx.num_workers

    def _on_mesh(self) -> dict:
        """The scan's placement argument: worker w's morsels to its mesh
        device (the reference's ``sharding=``); nothing off the mesh, so a
        source's own ``scan`` that takes no mesh still works there."""
        return {} if self.ctx.mesh is None else {"mesh": self.ctx.mesh}

    def _materialize(self, batches: Iterator[Step]) -> List[TorchTable]:
        """Drain a stream into one table per worker."""
        got = list(batches)
        assert got, "empty stream"
        return [concat_tables([step[k] for step in got])
                for k in range(len(got[0]))]

    def _rebatch(self, tables: List[TorchTable]) -> Iterator[Step]:
        """Split the workers' (equal-capacity) tables back into
        ``batch_rows``-row steps."""
        cap = tables[0].capacity
        step = self.ctx.batch_rows
        if cap <= step:
            yield tables
            return
        for lo in range(0, cap, step):
            hi = min(lo + step, cap)
            yield [TorchTable({n: a[lo:hi] for n, a in t.columns.items()},
                              t.validity[lo:hi], t.schema) for t in tables]

    def _operators(self, make: Callable[[], ops.Operator]) -> List[ops.Operator]:
        """One operator instance per worker."""
        return [make() for _ in range(self._w)]

    def _run_pipeline(self, workers: List[ops.Operator],
                      stream: Iterator[Step]) -> Iterator[Step]:
        """Each worker's operator on that worker's batch of every step
        (behind a host round trip when the operator is host-only)."""
        trips = self._maybe_host_wrap(workers[0])
        t0 = time.perf_counter()
        for op in workers:
            op.open()
        for step in stream:
            if trips is not None:
                step = [rt.add_input(b)[0] for rt, b in zip(trips, step)]
            yield from _lockstep([op.add_input(b)
                                  for op, b in zip(workers, step)])
        yield from _lockstep([op.finish() for op in workers])
        name = workers[0].name
        self.op_seconds[name] = (self.op_seconds.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def _run_stacked(self, op: ops.Operator,
                     stream: Iterator[Step]) -> Iterator[Step]:
        """One operator over whole steps (the ``GraceHashJoin``, which
        partitions all workers' rows together): each step in, steps out,
        behind a host round trip per worker when the operator is
        host-only."""
        trips = self._maybe_host_wrap(op)
        t0 = time.perf_counter()
        op.open()
        for step in stream:
            if trips is not None:
                step = [rt.add_input(b)[0] for rt, b in zip(trips, step)]
            yield from op.add_input(step)
        yield from op.finish()
        self.op_seconds[op.name] = (self.op_seconds.get(op.name, 0.0)
                                    + time.perf_counter() - t0)

    def _maybe_host_wrap(self, op: ops.Operator
                         ) -> Optional[List[ops.HostRoundTrip]]:
        """One ``HostRoundTrip`` per worker before a host-only operator's
        input (the CudfToVelox/CudfFromVelox pair), else None."""
        if op.name not in self.ctx.host_only_ops:
            return None
        return [ops.HostRoundTrip(self.conversion_stats)
                for _ in range(self._w)]

    def _scan_steps(self, morsels: Iterator[Step],
                    scans: List[StreamingScan]) -> Iterator[Step]:
        """Drain the prefetch queue through each worker's fused per-morsel
        pipeline."""
        spent = 0.0
        for scan in scans:
            ops.fuse_morsel_pipeline(scan.pipe)
            scan.pipe.open()
        for step in morsels:
            t0 = time.perf_counter()
            outs = [s.pipe.add_input(m) for s, m in zip(scans, step)]
            spent += time.perf_counter() - t0
            yield from _lockstep(outs)
        t0 = time.perf_counter()
        outs = [s.pipe.finish() for s in scans]
        spent += time.perf_counter() - t0
        self.op_seconds["StreamingScan"] = (
            self.op_seconds.get("StreamingScan", 0.0) + spent)
        yield from _lockstep(outs)

    def _maybe_stage(self, tables: List[TorchTable]) -> List[TorchTable]:
        """Stage an oversized exchange send buffer through the spill store
        (device -> pinned host -> paged disk as the tiers fill) instead of
        pinning it in device memory alongside the receive buffers; each
        worker's table is one spilled partition, restored onto that
        worker's device."""
        spill = self.ctx.spill
        if spill is None or not spill.should_stage(
                sum(t.nbytes() for t in tables)):
            return tables
        keys = []
        for t in tables:
            keys.append(("exchange-stage", self._spill_seq))
            self._spill_seq += 1
            spill.spill_table(keys[-1], t)
        self.spill_staged_exchanges += 1
        return [spill.restore(k) for k in keys]

    def _repartition(self, tables: List[TorchTable], keys: Sequence[str],
                     label: str = "repartition") -> List[TorchTable]:
        return self._tracked(
            f"{label}({','.join(keys)})",
            lambda: self.ctx.exchange.repartition(self._maybe_stage(tables),
                                                  tuple(keys), self._w))

    def _broadcast(self, tables: List[TorchTable],
                   label: str = "broadcast") -> List[TorchTable]:
        return self._tracked(
            label, lambda: self.ctx.exchange.broadcast(
                self._maybe_stage(tables), self._w))

    def _tracked(self, label: str, fn):
        """Run one exchange, recording its stats delta as a fragment entry."""
        st = self.ctx.exchange.stats
        before = dataclasses.replace(st)
        out = fn()
        self.exchange_stats[f"#{self._frag_seq} {label}"] = {
            "rounds": st.rounds - before.rounds,
            "rows_moved": st.rows_moved - before.rows_moved,
            "bytes_moved": st.bytes_moved - before.bytes_moved,
            "host_staged_bytes": (st.host_staged_bytes
                                  - before.host_staged_bytes),
            "seconds": st.seconds - before.seconds,
        }
        self._frag_seq += 1
        return out

    # -- recursive plan execution ----------------------------------------------
    def _stream(self, node: P.PlanNode) -> Stream:
        name = type(node).__name__
        method = getattr(self, f"_exec_{name.lower()}", None)
        if method is None:
            raise NotImplementedError(
                f"repro_torch: {name} comes with a later slice")
        stream = method(node)
        if (self.ctx.feedback is None
                or isinstance(node, (P.Repartition, P.Broadcast, P.Exchange))):
            # exchange nodes are keyed through (plan.feedback_key looks at
            # their child), so counting them would double-observe the child
            return stream
        return self._observe(node, stream)

    def _observe(self, node: P.PlanNode, stream: Stream) -> Stream:
        """Wrap a stage output in valid-row counters, one a worker on that
        worker's device. The wrapped stream keeps the child's scans, so
        later Filter, Project and single-match probe stages still fuse,
        and a scan counts the rows left after them, as in the
        reference."""
        counts = [torch.zeros((), dtype=torch.int64,
                              device=self.ctx.worker_device(w))
                  for w in range(self._w)]

        def counted(steps: Iterator[Step]) -> Iterator[Step]:
            for step in steps:
                for count, t in zip(counts, step):
                    count.add_(t.num_valid())
                yield step

        self._feedback_obs += [(node, c, stream.dist) for c in counts]
        return Stream(counted(stream.batches), stream.dist, scans=stream.scans)

    def _observe_join_build(self, node: P.Join, build: List[TorchTable],
                            dist: str) -> None:
        """Record a join's exact-key build multiplicity, the most valid
        build rows sharing one key value, which bounds the matches of a
        probe row. Only for a single int-like key, where equality has no
        hash collisions. Computed on worker 0's device with static shapes
        (the workers' keys gathered there first: a key value may lie on
        several workers when the build is not hash-partitioned; dead rows
        sort last under a key no int32 value takes, and count 0), so
        nothing is read back here."""
        kt = [build[0].schema[k] for k in node.build_keys]
        if len(kt) != 1 or kt[0].name not in ("int32", "date32", "dict32"):
            return
        if dist == "replicated" and self._w > 1:
            build = build[:1]                   # identical worker replicas
        key = node.build_keys[0]
        dev = build[0].device
        keys = torch.cat([t.columns[key].to(dev, torch.int64)
                          for t in build])
        valid = torch.cat([t.validity.to(dev) for t in build])
        if keys.numel() == 0:
            # an empty build bounds nothing tighter than one match
            self._feedback_matches[id(node)] = torch.ones(
                (), dtype=torch.int64, device=keys.device)
            return
        dead = torch.iinfo(torch.int64).max
        s = torch.sort(torch.where(valid, keys, dead)).values
        runs = (torch.searchsorted(s, s, right=True)
                - torch.searchsorted(s, s, right=False))
        most = torch.where(s != dead, runs, 0).max()
        self._feedback_matches[id(node)] = most.clamp_min(1)

    def _harvest_feedback(self) -> None:
        """Read every observation back in one transfer and record it in
        the feedback store (once, after the result materialized), a node's
        rows summed over its workers. The host seconds spent recording,
        after the read-back, are ``op_seconds["FeedbackHarvest"]``."""
        fb = self.ctx.feedback
        if fb is None or not self._feedback_obs:
            return
        from .optimizer import row_bound
        match_ids = list(self._feedback_matches)
        scalars = [c for _, c, _ in self._feedback_obs] + [
            self._feedback_matches[i] for i in match_ids]
        values = self._read_back(scalars)
        t0 = time.perf_counter()
        w = self._w
        nodes = self._feedback_obs[::w]     # a counter a worker, in order
        counts = [sum(values[k * w:(k + 1) * w]) for k in range(len(nodes))]
        matches = dict(zip(match_ids, values[len(self._feedback_obs):]))
        for (node, _, dist), rows in zip(nodes, counts):
            if dist == "replicated" and self._w > 1:
                rows //= self._w                # identical worker replicas
            try:
                est = row_bound(node, self.ctx.catalog)
            except Exception:
                est = None                      # exchange-wrapped subtree
            skip = None
            if isinstance(node, P.TableScan):
                stats = self.scan_stats.get(node.table)
                if stats is not None and stats.chunks_total:
                    skip = stats.chunks_skipped / stats.chunks_total
            fb.record(fb.key_for(node, self.ctx.catalog, self._w), rows,
                      estimated=est, max_matches=matches.get(id(node)),
                      skip_fraction=skip)
        self._feedback_obs = []
        self._feedback_matches = {}
        self.op_seconds["FeedbackHarvest"] = time.perf_counter() - t0

    def _read_back(self, scalars: List[torch.Tensor]) -> List[int]:
        """The values of 0-d tensors in one read-back: stacked, or on
        several devices each device's stacked there and copied to worker
        0's device first."""
        by_device: Dict[torch.device, List[int]] = {}
        for i, c in enumerate(scalars):
            by_device.setdefault(c.device, []).append(i)
        if len(by_device) == 1:
            return torch.stack(scalars).tolist()
        first = self.ctx.worker_device(0)
        read = torch.cat([torch.stack([scalars[i] for i in idx]).to(first)
                          for idx in by_device.values()]).tolist()
        values = [0] * len(scalars)
        for i, v in zip((i for idx in by_device.values() for i in idx), read):
            values[i] = v
        return values

    def _exec_tablescan(self, node: P.TableScan) -> Stream:
        src = self.ctx.catalog.get(node.table)
        stats = self.scan_stats.setdefault(node.table, ScanStats())
        if self.ctx.streaming:
            morsels = src.stream(node.columns, self.ctx.batch_rows,
                                 self.ctx.device,
                                 prefetch_depth=self.ctx.prefetch_depth,
                                 stats=stats, num_workers=self._w,
                                 filter_expr=node.filter,
                                 host_budget=self.ctx.host_budget(),
                                 **self._on_mesh())
            scans = [StreamingScan(node.table) for _ in range(self._w)]
            steps = self._scan_steps(morsels, scans)
            if node.filter is None:
                return Stream(steps, scans=scans)
            if "FilterProject" not in self.ctx.host_only_ops:
                for scan in scans:
                    scan.fuse(ops.FilterProject(node.filter))
                return Stream(steps, scans=scans)
        else:
            # synchronous baseline: read and copy inline with compute, and
            # nothing fuses into the scan
            steps = src.scan(node.columns, self.ctx.batch_rows,
                             self.ctx.device, filter_expr=node.filter,
                             stats=stats, num_workers=self._w,
                             **self._on_mesh())
            if node.filter is None:
                return Stream(steps)
        # the filter runs as its own pipeline, unfused
        return Stream(self._run_pipeline(
            self._operators(lambda: ops.FilterProject(node.filter)), steps))

    def _exec_inmemorysource(self, node: P.InMemorySource) -> Stream:
        """Host arrays as a source, scanned synchronously in morsels split
        across the workers as a catalog table's are (nothing fuses into
        it)."""
        from .session import InMemoryTable    # session imports the driver
        src = InMemoryTable(node.name, node.data, node.schema)
        return Stream(src.scan(None, self.ctx.batch_rows, self.ctx.device,
                               num_workers=self._w, **self._on_mesh()))

    def _fuse_or_run(self, child: Stream,
                     make: Callable[[], ops.Operator]) -> Stream:
        """Fuse a per-morsel operator into the child's scans, or run it
        over the child's stream (a host-only operator never fuses)."""
        if (child.scans is not None
                and make().name not in self.ctx.host_only_ops):
            for scan in child.scans:     # per-morsel, inside the scan stage
                scan.fuse(make())
            return child
        return Stream(self._run_pipeline(self._operators(make),
                                         child.batches), child.dist)

    def _exec_filter(self, node: P.Filter) -> Stream:
        return self._fuse_or_run(
            self._stream(node.child),
            lambda: ops.FilterProject(node.predicate, None, node.compact))

    def _exec_project(self, node: P.Project) -> Stream:
        return self._fuse_or_run(
            self._stream(node.child),
            lambda: ops.FilterProject(None, node.projections))

    def _release_after(self, batches: Iterator[Step],
                       op_key: str) -> Iterator[Step]:
        """Yield through ``batches``; return the operator's device
        reservation to the spill manager when the stream is drained."""
        try:
            yield from batches
        finally:
            self.ctx.spill.release(op_key)

    def _agg_spill(self, node: P.Aggregation) -> dict:
        """Spill kwargs for one aggregation's operators: reserve the
        accumulators' footprint; a shortfall runs them in flush-to-host
        mode with the flush point scaled to the granted fraction."""
        spill = self.ctx.spill
        if spill is None:
            return {}
        from .optimizer import infer_schema, row_width
        try:
            width = row_width(infer_schema(node, self.ctx.catalog))
        except (TypeError, KeyError):
            width = 64
        # accumulator + the concat-merge scratch copy, per worker
        want = 2 * width * node.max_groups * self._w
        op_key = f"agg{self._spill_seq}"
        self._spill_seq += 1
        granted = spill.reserve(op_key, want, minimum=min(want, _MIN_GRANT))
        if granted >= want:
            spill.release(op_key)
            return {}
        flush = max(1, (node.max_groups * granted) // max(want, 1))
        return {"spill": spill, "spill_flush_groups": flush,
                "op_key": op_key}

    def _exec_aggregation(self, node: P.Aggregation) -> Stream:
        child = self._stream(node.child)
        mode = node.mode
        if mode == "auto":
            mode = ("single" if self._w == 1 or child.dist == "replicated"
                    else "two_phase")

        def pipeline(agg_mode, batches):
            sk = self._agg_spill(node)
            op_key = sk.pop("op_key", None)
            out = self._run_pipeline(
                self._operators(lambda: ops.HashAggregation(
                    node.group_keys, node.aggs, agg_mode, node.max_groups,
                    **sk)),
                batches)
            return self._release_after(out, op_key) if op_key else out

        if mode in ("single", "partial", "final"):
            return Stream(pipeline(mode, child.batches), child.dist)

        # two-phase: partial -> exchange on the keys -> final (Velox's
        # Partial/Final modes with a Presto exchange between the stages)
        table = self._materialize(pipeline("partial", child.batches))
        if node.group_keys:
            exchanged = self._repartition(table, node.group_keys, "agg")
            dist = "partitioned"
        else:
            # a global aggregate: replicate the partials
            exchanged = self._broadcast(table, "agg-broadcast")
            dist = "replicated"
        return Stream(pipeline("final", self._rebatch(exchanged)), dist)

    def _exec_distinct(self, node: P.Distinct) -> Stream:
        child = self._stream(node.child)
        local = self._run_pipeline(
            self._operators(lambda: ops.Distinct(node.keys, node.max_groups)),
            child.batches)
        # explicit partial/final fragments (a planner-placed exchange between
        # them) run the local dedup only; 'auto' keeps the runtime exchange
        if (node.mode in ("partial", "final") or self._w == 1
                or child.dist == "replicated"):
            return Stream(local, child.dist)
        exchanged = self._repartition(self._materialize(local), node.keys,
                                      "distinct")
        return Stream(self._run_pipeline(
            self._operators(lambda: ops.Distinct(node.keys, node.max_groups)),
            self._rebatch(exchanged)), "partitioned")

    def _exec_scalarbroadcast(self, node: P.ScalarBroadcast) -> Stream:
        # the scalar side runs to its end first, as in the reference
        scalar_stream = self._stream(node.scalar)
        scalar = self._materialize(scalar_stream.batches)
        if self._w > 1 and scalar_stream.dist != "replicated":
            scalar = self._broadcast(scalar, "scalar-broadcast")
        child = self._stream(node.child)
        workers = self._operators(lambda: ops.ScalarBroadcast(node.columns))
        for sb, s in zip(workers, scalar):
            sb.set_scalar(s)
        return Stream(self._run_pipeline(workers, child.batches), child.dist)

    def _exec_join(self, node: P.Join) -> Stream:
        build_stream = self._stream(node.build)
        build = self._materialize(build_stream.batches)
        if self.ctx.feedback is not None:
            self._observe_join_build(node, build, build_stream.dist)
        probe = self._stream(node.probe)
        dist, probe_batches, probe_scans = probe.dist, probe.batches, probe.scans
        if self._w > 1:
            if node.distribution == "broadcast":
                if build_stream.dist != "replicated":
                    build = self._broadcast(build, "join-build-broadcast")
            elif node.distribution == "partitioned":
                if build_stream.dist != "replicated":
                    build = self._repartition(build, node.build_keys,
                                              "join-build")
                probe_tab = self._repartition(
                    self._materialize(probe_batches), node.probe_keys,
                    "join-probe")
                probe_batches = self._rebatch(probe_tab)
                probe_scans = None      # the scan is already drained
                dist = "partitioned"
            # 'local': co-partitioned already, no movement
        spill = self.ctx.spill
        op_key = None
        if spill is not None:
            # reserve the build side + hash state + probe headroom; a
            # shortfall routes the join through the grace-partitioned path,
            # which no scan fuses
            want = 2 * sum(t.nbytes() for t in build)
            op_key = f"join{self._spill_seq}"
            self._spill_seq += 1
            granted = spill.reserve(op_key, want,
                                    minimum=min(want, _MIN_GRANT))
            if granted < want:
                join = ops.GraceHashJoin(
                    node.build_keys, node.probe_keys, node.build_payload,
                    node.join_type, node.max_matches,
                    build_rows=node.build_rows, spill=spill,
                    reservation=granted)
                join.open()
                join.add_build(build)
                join.seal_build()
                del build   # partitioned into the spill hierarchy
                out = self._run_stacked(join, probe_batches)
                return Stream(self._release_after(out, op_key), dist)
        joins = self._operators(lambda: ops.HashJoin(
            node.build_keys, node.probe_keys, node.build_payload,
            node.join_type, node.max_matches, build_rows=node.build_rows))
        for join, b in zip(joins, build):
            join.open()
            join.add_build(b)
            join.seal_build()
        if (probe_scans is not None and not joins[0]._multi
                and joins[0].name not in self.ctx.host_only_ops):
            # fuse the probe into each worker's per-morsel scan pipeline,
            # where the iteration-start collapse folds it and the stages
            # before it into one fused launch per morsel; the join's time
            # folds into the StreamingScan entry of op_seconds, and the
            # returned stream drops the scans so later stages keep their own
            # launches
            for scan, join in zip(probe_scans, joins):
                scan.fuse(join)
            out = probe_batches
        else:
            out = self._run_pipeline(joins, probe_batches)
        if op_key is not None:
            out = self._release_after(out, op_key)
        return Stream(out, dist)

    def _exec_orderby(self, node: P.OrderBy) -> Stream:
        child = self._stream(node.child)
        # compact away dead padding (e.g. max_groups slots) before sorting
        table = maybe_compact(self._materialize(child.batches))
        workers = self._operators(
            lambda: ops.OrderBy(node.keys, node.descending, node.limit))
        if node.local:
            # distributed top-N partial: each worker sorts and truncates its
            # own slice; the planner's Broadcast above gathers the candidates
            return Stream(self._run_pipeline(workers, iter([table])),
                          child.dist)
        if self._w > 1 and child.dist != "replicated":
            table = self._broadcast(table, "orderby-gather")  # global order
        return Stream(self._run_pipeline(workers, iter([table])),
                      "replicated")

    def _exec_limit(self, node: P.Limit) -> Stream:
        child = self._stream(node.child)
        table = self._materialize(child.batches)
        if self._w > 1 and child.dist != "replicated":
            table = self._broadcast(table, "limit-gather")
        return Stream(self._run_pipeline(
            self._operators(lambda: ops.Limit(node.n)), iter([table])),
            "replicated")

    def _exec_exchange(self, node, label: str = "exchange") -> Stream:
        child = self._stream(node.child)
        exchanged = self._repartition(self._materialize(child.batches),
                                      node.keys, label)
        return Stream(self._rebatch(exchanged), "partitioned")

    def _exec_repartition(self, node: P.Repartition) -> Stream:
        """Planner-placed hash exchange: the Exchange node's execution,
        under its fragment label."""
        return self._exec_exchange(node, label="Repartition")

    def _exec_broadcast(self, node: P.Broadcast) -> Stream:
        """Planner-placed replication: every worker receives all valid rows
        of the child (a no-op for a stream already replicated, which would
        otherwise multiply its rows)."""
        child = self._stream(node.child)
        table = self._materialize(child.batches)
        if child.dist != "replicated":
            table = self._broadcast(table, "Broadcast")
        return Stream(self._rebatch(table), "replicated")
