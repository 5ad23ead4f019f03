"""Session & catalog (the port of ``repro.core.session``).

A ``Session`` binds a catalog of tables to an execution configuration and
runs logical plans through the ``Driver``::

    from repro_torch.core.session import Session
    from repro_torch.tpch import dbgen, queries

    catalog = dbgen.load_catalog(sf=0.01)
    session = Session(catalog)                  # device=None: the GPU
    out = session.execute(queries.build_query(6, catalog))  # name -> column
    top = (session.table("orders").group_by("o_orderpriority")
           .agg(n=("count", None)).collect())   # the fluent builder

``Session(device=None)`` means ``"cuda"`` and raises when no GPU is present;
``device="cpu"`` runs the plain PyTorch versions of the kernels.

Several cards (the reference's ``Session(mesh=...)``): worker w's tables
live on ``mesh.device_of(w, W)`` and the exchange moves rows between them
device to device::

    from repro_torch.launch.mesh import make_engine_mesh

    session = Session(catalog, num_workers=4, mesh=make_engine_mesh(4))
    out = session.execute(queries.build_query(5, catalog, num_workers=4))

Serving path (many queries, scheduled concurrently under a device-memory
budget, with plan and result caches and, opt-in, inter-query batching)::

    from repro_torch import SchedulerConfig

    session.scheduler_config = SchedulerConfig(batching=True)
    h1 = session.submit(queries.build_query(1, catalog))
    h6 = session.submit(queries.build_query(6, catalog))
    q1, q6 = session.gather(h1, h6)       # morsel pipelines interleave
    out = session.run(queries.build_query(14, catalog))
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..device import indexed, resolve_device
from .builder import QueryBuilder
from .driver import Driver, ExecutionContext, empty_executor_stats
from .exchange import ExchangeProtocol
from .optimizer import (OptimizerConfig, estimate_memory_breakdown,
                        explain_before_after, optimize)
from .plan import PlanNode
from .streaming import (HostMorsel, MorselPrefetcher, ScanStats,
                        morsel_to_device, worker_devices)
from .table import TorchTable


class TableSource:
    """Abstract storage backend for one catalog table.

    Backends implement ``_host_morsels`` (host-side reads only) and
    ``num_rows``; ``scan`` copies the reads to the device inline, ``stream``
    through a prefetcher. Implementations: ``InMemoryTable`` (numpy), and
    the chunked file formats ``storage.colchunk.ColumnChunkTable`` and
    ``storage.paged.PagedTableSource`` (both with zone-map skipping)."""

    name: str
    schema: dict
    # column sets that uniquely identify a row (primary/candidate keys)
    unique_keys: tuple = ()

    def num_rows(self) -> int:
        """Total rows in the table (the statistic plans are sized from)."""
        raise NotImplementedError

    def _host_morsels(self, columns, batch_rows: int,
                      stats: Optional[ScanStats] = None,
                      num_workers: int = 1, filter_expr=None,
                      pin: bool = False) -> Iterator[List[HostMorsel]]:
        """Host-side scan steps (storage reads only, no device copy): each
        step is a list of one morsel per worker. ``filter_expr`` is the
        pushed-down predicate a backend may skip data by (rows it does not
        skip are still filtered downstream); ``pin`` asks for buffers in
        pinned memory, for a copy to a CUDA device."""
        raise NotImplementedError

    def scan(self, columns, batch_rows: int, device, filter_expr=None,
             stats: Optional[ScanStats] = None,
             num_workers: int = 1, mesh=None) -> Iterator[List[TorchTable]]:
        """Synchronous scan: each step is read and copied to ``device``
        inline on the caller's thread, on the current stream (the
        materialize-then-run baseline the paper starts from); on a
        ``mesh`` (``launch.mesh.EngineMesh``) morsel w goes to worker w's
        device instead::

            src = session.catalog.get("lineitem")
            for step in src.scan(["l_quantity"], 4096, "cpu"):
                print(step[0].capacity)         # one table per worker
        """
        devices = worker_devices(device, num_workers, mesh)
        for step in self._host_morsels(
                columns, batch_rows, stats=stats, num_workers=num_workers,
                filter_expr=filter_expr,
                pin=any(d.type == "cuda" for d in devices)):
            if stats is not None:
                stats.morsels += 1
                stats.bytes_transferred += sum(h.nbytes() for h in step)
            yield [morsel_to_device(h, d) for h, d in zip(step, devices)]

    def stream(self, columns, batch_rows: int, device, prefetch_depth: int = 2,
               stats: Optional[ScanStats] = None,
               num_workers: int = 1, filter_expr=None,
               host_budget=None, mesh=None) -> MorselPrefetcher:
        """Asynchronous scan: a background thread reads step N+1 and
        copies its morsels to ``device`` (on a ``mesh``, morsel w to
        worker w's device) while step N computes; counters accumulate into
        ``stats``::

            stats = ScanStats()
            for step in src.stream(None, 4096, "cuda", stats=stats):
                pass                            # compute overlaps next read
            print(stats.prefetch_overlap)       # fraction of I/O hidden

        A source that overrides only ``scan`` (its steps already on the
        device) is prefetched too: its steps feed the same bounded queue.
        ``host_budget`` (a ``core.spill.HostMemoryBudget``) bounds the
        queued steps' host bytes as well (the spill manager's shared
        meter)."""
        if (type(self)._host_morsels is TableSource._host_morsels
                and type(self).scan is not TableSource.scan):
            # off the mesh the call is as before, for a ``scan`` that
            # takes no mesh
            on_mesh = {} if mesh is None else {"mesh": mesh}
            gen = self.scan(columns, batch_rows, device,
                            filter_expr=filter_expr, num_workers=num_workers,
                            **on_mesh)
        else:
            devices = worker_devices(device, num_workers, mesh)
            gen = self._host_morsels(
                columns, batch_rows, stats=stats, num_workers=num_workers,
                filter_expr=filter_expr,
                pin=any(d.type == "cuda" for d in devices))
        return MorselPrefetcher(gen, device, depth=prefetch_depth, stats=stats,
                                host_budget=host_budget, mesh=mesh)


class InMemoryTable(TableSource):
    """Numpy-backed table; rows are range-partitioned across workers and
    scanned in ``batch_rows`` morsels.

    Worker k owns rows ``[k * per_worker, (k + 1) * per_worker)`` with
    ``per_worker = ceil(n / W)``; step b gives every worker its rows
    ``[b * batch_rows, (b + 1) * batch_rows)`` of that range in a morsel of
    the same capacity, a short worker's padded with dead rows (the
    reference's split). At W = 1 the morsels are views of the arrays."""

    def __init__(self, name: str, data: Dict[str, np.ndarray], schema: dict,
                 unique_keys: tuple = ()):
        self.name = name
        self.data = {k: np.asarray(v, dtype=schema[k].np_dtype())
                     for k, v in data.items()}
        self.schema = dict(schema)
        self.unique_keys = tuple(tuple(u) for u in unique_keys)
        self._n = len(next(iter(self.data.values()))) if self.data else 0

    def num_rows(self) -> int:
        return self._n

    def _host_morsels(self, columns, batch_rows: int,
                      stats: Optional[ScanStats] = None,
                      num_workers: int = 1, filter_expr=None,
                      pin: bool = False) -> Iterator[List[HostMorsel]]:
        # filter_expr and pin are ignored: the table keeps no stats to skip
        # by, and a whole morsel is a view of the arrays (the copy to a
        # CUDA device pins it)
        cols = list(columns) if columns else list(self.data.keys())
        schema = {c: self.schema[c] for c in cols}
        n = self._n
        per_worker = math.ceil(n / num_workers) if n else 1
        for lo in range(0, per_worker, batch_rows):
            hi = min(lo + batch_rows, per_worker)
            cap = hi - lo
            step = []
            for wk in range(num_workers):
                s = min(wk * per_worker + lo, n)
                e = min(wk * per_worker + hi, n)
                if e - s == cap:        # a whole morsel: views, no copy
                    bufs = {c: self.data[c][s:e] for c in cols}
                else:                   # a short worker: dead padding
                    bufs = {}
                    for c in cols:
                        d = schema[c]
                        bufs[c] = np.zeros(d.storage_shape(cap), d.np_dtype())
                        bufs[c][:e - s] = self.data[c][s:e]
                validity = np.zeros(cap, dtype=bool)
                validity[:e - s] = True
                if stats is not None:
                    stats.bytes_read += sum(b.nbytes for b in bufs.values())
                step.append(HostMorsel(bufs, validity, schema))
            yield step


class Catalog:
    """Named ``TableSource`` registry (a Presto connector catalog).

    Every (re-)registration bumps the table's *version*; the scheduler's
    plan and result caches snapshot versions at insert time and treat any
    bump as invalidation, so re-registering a table (new data under the
    same name) never serves stale cached results.
    """

    def __init__(self):
        self._tables: Dict[str, TableSource] = {}
        self._versions: Dict[str, int] = {}

    @classmethod
    def from_numpy(cls, tables: Dict[str, Dict[str, np.ndarray]],
                   schemas: Dict[str, dict],
                   unique_keys: Optional[Dict[str, tuple]] = None
                   ) -> "Catalog":
        """A catalog of ``InMemoryTable``s over host arrays, e.g. the tables
        another engine generated, so that both scan the same bytes.
        ``unique_keys`` maps a table name to its tuple of key-column
        tuples."""
        cat = cls()
        for name, data in tables.items():
            cat.register(InMemoryTable(name, data, schemas[name],
                                       (unique_keys or {}).get(name, ())))
        return cat

    def register(self, source: TableSource):
        """Add or replace a table; bumps its version."""
        self._tables[source.name] = source
        self._versions[source.name] = self._versions.get(source.name, 0) + 1

    def register_numpy(self, name: str, data: Dict[str, np.ndarray], schema,
                       unique_keys: tuple = ()):
        """Register a dict of numpy arrays as an ``InMemoryTable``."""
        self.register(InMemoryTable(name, data, schema, unique_keys))

    def get(self, name: str) -> TableSource:
        """Look up a table source; raises ``KeyError`` if unknown."""
        return self._tables[name]

    def tables(self):
        """Registered table names."""
        return list(self._tables)

    def version(self, name: str) -> int:
        """Monotonic registration counter for ``name`` (0 = never seen)."""
        return self._versions.get(name, 0)

    def versions(self, names) -> tuple:
        """Sorted ``(name, version)`` snapshot for cache-validity checks."""
        return tuple(sorted((n, self.version(n)) for n in names))


@dataclasses.dataclass(frozen=True)
class ExecutionOptions:
    """Per-query options for the serving entry points
    (``Session.submit``/``run``, ``QueryBuilder.submit``). ``None`` fields
    inherit the session's defaults, so ``ExecutionOptions()`` is a no-op::

        session.run(query, options=ExecutionOptions(priority=2))

    The reference's ``kernel_backend`` field has no counterpart: the port
    runs on the session's device.
    """

    # scheduler queue priority (higher dequeues first)
    priority: Optional[int] = None
    # worker count for this query only (the plan is optimized for it)
    num_workers: Optional[int] = None
    # run the logical optimizer before execution (default True)
    optimize: Optional[bool] = None
    # runtime-feedback override for this query only: ``True`` enables an
    # ephemeral ``core.feedback.FeedbackStore``, ``False`` disables the
    # session's store, or pass a ``FeedbackStore`` to share across queries
    feedback: Optional[object] = None
    # inter-query batching opt-out for this query only: ``False`` keeps it
    # out of stacked launches even when ``SchedulerConfig.batching`` is on
    batching: Optional[bool] = None


@dataclasses.dataclass
class Session:
    """The port's entry point: a catalog bound to an execution config.

    ``device=None`` means ``"cuda"`` and raises when there is no GPU.
    ``num_workers`` workers run on the one device, each with its own
    operators, and ``exchange`` moves rows between them (``None`` means
    ``ICIExchange(mesh=mesh)``; ``HostExchange()`` stages through host
    memory). With ``mesh`` (a ``launch.mesh.EngineMesh``) worker w runs on
    ``mesh.device_of(w, num_workers)``; ``device`` is then the mesh's first
    device (``None`` means that device; any other raises). Every entry
    point runs on the mesh: ``execute``, ``collect`` and ``sql``, the
    serving entry points, ``device_budget`` (one budget for the query over
    all cards; a spilled partition comes back on the card it left) and
    ``feedback``. A worker count the mesh cannot split raises
    ``ValueError``. Plan a query for the same worker count::

        session = Session(catalog, num_workers=4, exchange=HostExchange())
        out = session.execute(queries.build_query(5, catalog, num_workers=4))

    Each ``execute`` runs with a ``clone()`` of the protocol (zeroed
    stats); ``executor_stats()['exchanges']`` holds that query's counters.

    ``submit``/``gather``/``run`` route through a lazily created
    ``QueryScheduler`` (``core.scheduler``); configure it by assigning
    ``session.scheduler_config = SchedulerConfig(...)`` before first use.
    """

    catalog: Catalog
    batch_rows: int = 8192
    prefetch_depth: int = 2
    device: Optional[object] = None
    num_workers: int = 1
    exchange: Optional[ExchangeProtocol] = None
    # scheduler knobs (core.scheduler.SchedulerConfig); None = defaults.
    # Assign before the first submit()/run(): the scheduler is built lazily.
    scheduler_config: Optional[object] = None
    # morsel-driven scans: storage -> device prefetch on a thread with a
    # bounded queue of ``prefetch_depth`` steps (False = the synchronous
    # materialize-then-run baseline: read and copy inline, no fusion into
    # the scan)
    streaming: bool = True
    # operator names whose device version is declared unavailable: the
    # driver runs them behind a device -> host -> device round trip
    # (``operators.HostRoundTrip``, paper §3.1), counted in
    # ``executor_stats()["conversions"]``
    host_only_ops: frozenset = frozenset()
    # tiered-memory spill (core.spill): a device-memory budget in bytes
    # turns on out-of-core execution -- every query gets a SpillManager
    # (on a mesh one budget over all its cards, each partition restored
    # to the card it left), and the memory-hungry operators degrade through
    # pinned host buffers and paged disk files instead of exceeding the
    # budget. None = in-memory only.
    device_budget: Optional[int] = None
    # host-tier cap shared by spilled partitions and prefetched morsels
    host_budget: int = 1 << 31
    # directory for paged spill files (None = per-query temp dirs)
    spill_dir: Optional[str] = None
    # hard ceiling for the disk tier (the only tier that rejects work)
    disk_ceiling: int = 1 << 38
    # adaptive execution (core.feedback): ``True`` gives the session a
    # ``FeedbackStore`` recording observed per-node cardinalities after
    # every query; the optimizer then re-plans warm runs from those
    # observations (tighter capacities, feedback-driven build-side
    # selection) and the scheduler evicts cached plans whose estimates
    # drifted. Pass an existing ``FeedbackStore`` to share one across
    # sessions; ``None`` disables adaptivity entirely.
    feedback: Optional[object] = None
    # the worker mesh (launch.mesh.EngineMesh, the reference's jax Mesh
    # with a 'workers' axis): worker w's tables live on
    # mesh.device_of(w, num_workers). None = every worker on ``device``
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            first = resolve_device(self.mesh.devices[0])
            if self.device is not None and (
                    indexed(resolve_device(self.device)) != first):
                raise ValueError(f"Session: device {self.device} is not the "
                                 f"mesh's first device {first}")
            self.device = first
            self.mesh.check(self.num_workers)
        self.device = resolve_device(self.device)
        self.last_driver: Optional[Driver] = None

    def feedback_store(self):
        """The session's ``core.feedback.FeedbackStore``, or ``None`` when
        adaptivity is off. Normalizes ``feedback=True`` into a concrete
        store on first use (thread-safe; all later calls share it)."""
        fb = self.feedback
        if fb is True:
            with Session._scheduler_lock:
                if self.feedback is True:
                    from .feedback import FeedbackStore
                    self.feedback = FeedbackStore()
                fb = self.feedback
        return fb if fb is not None and fb is not False else None

    def context(self) -> ExecutionContext:
        """Snapshot this session's execution config for one Driver run
        (each context gets its own per-query ``SpillManager`` when the
        session has a ``device_budget``)."""
        exchange = self.exchange.clone() if self.exchange is not None else None
        spill = None
        if self.device_budget is not None:
            from .spill import SpillManager
            spill = SpillManager(self.device_budget, self.host_budget,
                                 spill_dir=self.spill_dir,
                                 disk_ceiling=self.disk_ceiling,
                                 device=self.device)
        return ExecutionContext(catalog=self.catalog, device=self.device,
                                num_workers=self.num_workers,
                                exchange=exchange, mesh=self.mesh,
                                batch_rows=self.batch_rows,
                                prefetch_depth=self.prefetch_depth,
                                streaming=self.streaming,
                                host_only_ops=frozenset(self.host_only_ops),
                                spill=spill,
                                feedback=self.feedback_store())

    def _with_options(self, options: Optional[ExecutionOptions]
                      ) -> "Session":
        """This session with a query's overrides applied (the direct path
        of ``execute`` and ``QueryBuilder.collect``): the worker count and
        the feedback store."""
        if options is None:
            return self
        repl = {}
        if options.num_workers is not None:
            repl["num_workers"] = options.num_workers
        if options.feedback is not None:
            repl["feedback"] = options.feedback
        return dataclasses.replace(self, **repl) if repl else self

    def table(self, name: str, columns=None) -> "QueryBuilder":
        """Fluent builder over a catalog table, bound to this session."""
        return QueryBuilder.scan(self.catalog, name, columns, session=self)

    def sql(self, text: str, options: Optional[ExecutionOptions] = None,
            dialect: Optional[str] = None) -> "QueryBuilder":
        """Parse SQL text into a session-bound ``QueryBuilder``
        (``core.sql.lower_sql``).

        The builder is a hand-built one in every respect: ``.collect()``,
        ``.submit()`` and ``.explain(analyze=True)`` work, and the
        optimizer and scheduler treat it alike (the text also prefixes the
        scheduler's plan and result cache keys)::

            out = session.sql(
                "SELECT l_returnflag, count(*) AS n FROM lineitem "
                "GROUP BY l_returnflag ORDER BY l_returnflag").collect()

        Unsupported constructs raise ``SqlUnsupportedError`` naming the
        node, syntax errors ``SqlParseError``, unknown tables or columns
        ``SchemaError``. ``dialect`` transpiles another dialect through the
        optional ``sqlglot`` package and raises without it. ``options``
        attaches ``ExecutionOptions`` that ``collect`` and ``submit`` pick
        up."""
        from .sql import lower_sql
        qb = lower_sql(text, self.catalog, session=self, dialect=dialect)
        qb._options = options
        return qb

    def optimizer_config(self) -> OptimizerConfig:
        """The optimizer's configuration for this session's worker count
        and feedback store (warm plans when the store has observations)."""
        return OptimizerConfig(num_workers=self.num_workers,
                               feedback=self.feedback_store())

    def optimize(self, plan: PlanNode) -> PlanNode:
        """Run the optimizer's rule pipeline over a logical plan."""
        return optimize(plan, self.catalog, config=self.optimizer_config())

    def explain(self, plan: PlanNode, analyze: bool = False) -> str:
        """The plan before and after optimization (``QueryBuilder.explain``
        delegates here).

        With ``analyze=True`` the optimized plan is also executed, and the
        executor's stats are appended (EXPLAIN ANALYZE): per table the scan
        counters (morsels, chunks, chunks skipped by zone maps, bytes read
        and copied to the device, prefetch overlap), operator seconds,
        kernel dispatches, per-fragment exchange counters, then the
        per-operator memory-footprint estimate (with the spill-cost
        estimate under a ``device_budget``) and the per-tier spill
        counters. With a feedback store the estimate prices the warm plan
        from what earlier runs observed."""
        text = explain_before_after(plan, self.catalog,
                                    config=self.optimizer_config())
        if not analyze:
            return text
        optimized = self.optimize(plan)
        breakdown = estimate_memory_breakdown(
            optimized, self.catalog, num_workers=self.num_workers,
            batch_rows=self.batch_rows, prefetch_depth=self.prefetch_depth,
            feedback=self.feedback_store())
        self.execute(optimized)
        lines = ["== executor stats =="]
        stats = self.executor_stats()
        for tname, s in sorted(stats["tables"].items()):
            lines.append(
                f"scan {tname}: morsels={s['morsels']} "
                f"chunks={s['chunks_total']} "
                f"chunks_skipped={s['chunks_skipped']} "
                f"bytes_read={s['bytes_read']} "
                f"bytes_transferred={s['bytes_transferred']} "
                f"prefetch_overlap={s['prefetch_overlap']:.2f}")
        for op, sec in sorted(stats["op_seconds"].items()):
            lines.append(f"op {op}: {sec:.4f}s")
        kd = stats["kernel_dispatch"]
        if kd:
            lines.append(f"kernels [{stats['device']}]: "
                         + " ".join(f"{k}={v}" for k, v in sorted(kd.items())))
        for frag, ex in stats["exchanges"].items():
            lines.append(
                f"exchange {frag} [{stats['exchange_protocol']}]: "
                f"rounds={ex['rounds']} rows_moved={ex['rows_moved']} "
                f"bytes_moved={ex['bytes_moved']} "
                f"host_staged_bytes={ex['host_staged_bytes']} "
                f"{ex['seconds']:.4f}s")
        lines.append("== memory ==")
        lines.extend(breakdown.describe(self.device_budget,
                                        self.host_budget).splitlines())
        spill = stats["spill"]
        if spill:
            lines.append(
                f"spill: reserved_peak={spill['reserved_peak']} "
                f"reserve_denials={spill['reserve_denials']} "
                f"staged_exchanges={stats['spill_staged_exchanges']}")
            for tier in ("host", "disk"):
                t = spill[tier]
                lines.append(
                    f"spill {tier} tier: spilled_bytes={t['spilled_bytes']} "
                    f"restored_bytes={t['restored_bytes']} "
                    f"spills={t['spills']} restores={t['restores']}")
        return text + "\n" + "\n".join(lines)

    def execute(self, plan: PlanNode,
                options: Optional[ExecutionOptions] = None
                ) -> Dict[str, np.ndarray]:
        """Execute one plan on this thread; returns name -> numpy column of
        valid rows. The direct path: no admission control, no caches.
        ``options`` applies the per-query ``num_workers`` and ``feedback``
        overrides (``priority`` means nothing here, and ``optimize`` is
        the caller's: the plan runs as given)::

            out = session.execute(plan, options=ExecutionOptions(
                num_workers=2))             # a plan built for two workers
        """
        driver = Driver(self._with_options(options).context())
        self.last_driver = driver
        return driver.collect(plan)

    def executor_stats(self) -> Dict[str, object]:
        """Stats from the most recent ``execute``; before any, the same
        keys with empty values (``driver.empty_executor_stats``). The
        ``feedback`` entry always reflects the session's live store (it
        accumulates across queries, unlike the per-query driver stats)."""
        stats = (empty_executor_stats() if self.last_driver is None
                 else self.last_driver.executor_stats())
        fb = self.feedback_store()
        if fb is not None:
            stats["feedback"] = fb.summary()
        return stats

    # -- serving entry points (core.scheduler) ------------------------------
    # guards lazy scheduler creation: N client threads whose first call is
    # submit() must all get the same scheduler (one budget, one cache)
    _scheduler_lock = threading.Lock()

    def scheduler(self):
        """The session's ``QueryScheduler`` (created on first use).

        Configure with ``session.scheduler_config = SchedulerConfig(...)``
        before the first call; later assignments need ``reset_scheduler``.
        """
        sched = getattr(self, "_scheduler", None)
        if sched is None:
            with Session._scheduler_lock:
                sched = getattr(self, "_scheduler", None)
                if sched is None:
                    from .scheduler import QueryScheduler
                    sched = QueryScheduler(self, self.scheduler_config)
                    self._scheduler = sched
        return sched

    def reset_scheduler(self) -> None:
        """Drop the current scheduler (and its caches and queue) if any."""
        sched = getattr(self, "_scheduler", None)
        if sched is not None:
            sched.close(wait=False)
            self._scheduler = None

    def submit(self, query, priority: int = 0,
               options: Optional[ExecutionOptions] = None):
        """Submit a query for scheduled execution; returns a
        ``QueryHandle``.

        ``query`` is a ``PlanNode`` or a ``QueryBuilder`` (its plan is
        taken as built; the scheduler optimizes through the plan cache; a
        builder from ``session.sql`` prefixes the cache keys with its
        text). ``options`` carries per-query overrides; a builder from
        ``session.sql(..., options=...)`` brings its own unless overridden
        here. Raises ``QueryRejected`` when admission control refuses it::

            h = session.submit(session.table("lineitem").limit(5), priority=1)
            rows = h.result()
        """
        plan = query.plan if hasattr(query, "plan") else query
        if options is None:
            options = getattr(query, "_options", None)
        sql = getattr(query, "sql_text", None)
        opts = options or ExecutionOptions()
        if opts.priority is not None:
            priority = opts.priority
        return self.scheduler().submit(
            plan, priority=priority, sql=sql, num_workers=opts.num_workers,
            optimize=opts.optimize, feedback=opts.feedback,
            batching=opts.batching)

    def gather(self, *handles) -> list:
        """Wait for ``submit`` handles; results in argument order."""
        return self.scheduler().gather(*handles)

    def run(self, query, priority: int = 0,
            options: Optional[ExecutionOptions] = None
            ) -> Dict[str, np.ndarray]:
        """Synchronous scheduled execution: ``submit`` + ``result``. Unlike
        ``execute``, this path gets admission control and the plan and
        result caches."""
        return self.submit(query, priority=priority,
                           options=options).result()
