"""Concurrent query scheduler (the port of ``repro.core.scheduler``):
admission control, plan and result caching, coalescing, priorities and
inter-query batching.

The paper's Presto integration is a *serving* system: the coordinator
admits many concurrent queries and the GPU workers multiplex them under a
fixed device-memory budget. This module is that layer:

* **Admission control** -- every query's peak device-memory footprint is
  estimated from its optimized plan (``optimizer.estimate_memory_breakdown``).
  Queries are admitted only while the sum of in-flight estimates fits
  ``SchedulerConfig.memory_budget``; the rest wait in a bounded priority
  queue. A footprint past ``spill_disk_ceiling`` or a full wait queue is
  rejected (``QueryRejected``), with the per-operator breakdown in the
  message. A footprint over the budget but under the ceiling is admitted
  with a priced spill plan (``QueryHandle.spill_plan``) and runs
  out of core, under a per-query ``core.spill.SpillManager`` whose device
  budget is the scheduler's whole ``memory_budget`` (on a mesh, one
  budget over all its cards, as the admission estimate is one figure).

* **Interleaved execution** -- admitted queries run on a pool of
  ``max_concurrency`` worker threads, each driving its own ``Driver`` on
  the session's device, or on a mesh session on each worker's card. Each
  kernel launches on its card's current stream, under that card's launch
  guard (``kernels.build.function(..., device=)``); every scan's
  ``MorselPrefetcher`` copies on a side stream a card, so one query's
  copies overlap another's kernels. A per-query worker count the mesh
  cannot split fails that query's handle with ``EngineMesh.check``'s
  ``ValueError``; it never runs off the mesh.

* **Plan cache** and **result cache** -- bounded LRUs keyed by the plan's
  fingerprint, the worker count and the session device's type; entries
  snapshot the versions of every referenced table and die when one is
  re-registered. Identical queries submitted while one is in flight
  coalesce onto its handle.

* **Inter-query batching** (``SchedulerConfig.batching``) -- a worker that
  dequeues a batchable query (``core.batch.extract_shape``) waits up to
  ``batch_window_ms`` for compatible pending queries and runs up to
  ``max_batch`` of them as one stacked scan (``Driver.collect_batch``).
  Batching is W = 1 only, as in the reference: on a one-card mesh the
  stacked scan runs on that card; a mesh of several cards cannot hold a
  W = 1 query at all, so no batch ever meets several cards.
  If the stacked run raises, every member runs solo, so a query that would
  succeed alone never receives a batched error; each such fallback counts
  in ``stats()["batch_fallbacks"]`` and leaves the error's text under
  ``executor_stats["batch"]["fallback"]`` on each member.

* **Adaptive re-planning** (a ``core.feedback.FeedbackStore`` on the
  session, or ``submit(feedback=...)``) -- a query is planned warm from the
  store, its driver harvests fresh observations, and a cached plan whose
  estimates miss them by more than ``feedback_qerror_limit`` is evicted,
  so the next identical submit re-plans; warm entries converge and stay
  cached. A query with a store is never batched.

Where the reference keys on the kernel backend, the port keys on the
session device's type (``"cuda"`` or ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..kernels import segmented_agg as _segagg
from . import batch as _batch
from . import plan as P
from .driver import Driver, empty_executor_stats
from .feedback import qerror
from .optimizer import estimate_memory_breakdown, feedback_estimates, optimize


class QueryRejected(RuntimeError):
    """Admission control refused the query (footprint beyond even the
    spill disk ceiling, or queue full). The message carries the
    per-operator footprint breakdown and spill-cost estimate."""


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs for admission control, the two caches and batching.

    ``memory_budget`` is the device memory admitted queries may pin
    together (on a mesh, over all its cards); ``max_concurrency`` the
    number of worker threads (concurrent query pipelines).
    """

    # total device-memory budget admitted queries may collectively pin
    memory_budget: int = 1 << 30
    # worker threads driving admitted queries (concurrent pipelines)
    max_concurrency: int = 8
    # bounded wait queue: submits beyond this are rejected (backpressure)
    max_queue: int = 64
    # LRU capacities for the two caches (entries, not bytes)
    plan_cache_size: int = 64
    result_cache_size: int = 64
    # serve repeated identical queries from the result cache
    cache_results: bool = True
    # anti-starvation: after the queue head has been passed over this many
    # times for smaller queries, backfilling stops until the head fits
    max_head_skips: int = 16
    # tiered-memory spill for over-budget queries (core.spill): host-tier
    # cap, the footprint past which a query is rejected (the disk ceiling),
    # and where the paged spill files go (None = per-query temp dirs)
    spill_host_budget: int = 1 << 31
    spill_disk_ceiling: int = 1 << 38
    spill_dir: Optional[str] = None
    # inter-query batching (core.batch): when True, a worker that dequeues
    # a batchable query (single-table filter/project/agg shape, W=1, no
    # feedback store, no spill) waits up to batch_window_ms for compatible
    # pending queries -- same interned program, device type and catalog
    # snapshot -- and launches up to max_batch of them as ONE stacked
    # execution. Strictly opt-in: when False no query grows batch state.
    batching: bool = False
    batch_window_ms: float = 2.0
    max_batch: int = 16
    # adaptive re-planning: a cached plan whose believed cardinalities
    # (static bounds, or the feedback observations it was planned from)
    # miss the fresh post-execution observations by more than this q-error
    # is evicted from the plan cache, so the next identical submit
    # re-optimizes against the updated feedback store. Feedback-planned
    # entries converge (estimate == observation) and stay cached.
    feedback_qerror_limit: float = 4.0


class QueryHandle:
    """Future-style handle for one submitted query.

    ``result()`` blocks until the query finishes and returns the collected
    numpy dict (or re-raises the query's error). Timing fields
    (``submitted_at``/``started_at``/``finished_at``, None until reached)
    give queue wait and run time; ``cache_hit`` says the result came from
    the result cache.
    """

    def __init__(self, query_id: int, plan: P.PlanNode, priority: int,
                 estimate: int):
        self.query_id = query_id
        self.plan = plan
        self.priority = priority
        self.estimate = estimate       # bytes charged against the budget
        self.footprint = estimate      # un-capped estimated peak footprint
        # optimizer.MemoryEstimate per-operator breakdown (None for
        # result-cache hits, which never reach estimation)
        self.memory_breakdown = None
        # spill_cost dict when the footprint exceeded the memory budget
        self.spill_plan: Optional[Dict] = None
        self.cache_hit = False
        self.plan_cache_hit = False
        # device type pinned at submit time ('cuda' or 'cpu'; the
        # reference's kernel backend)
        self.device_type: Optional[str] = None
        # worker count pinned at submit time (the plan and the cache keys
        # depend on it)
        self.num_workers: int = 1
        self._queue_skips = 0          # times passed over by backfilling
        self._versions: tuple = ()     # admission-time catalog snapshot
        self._result_key: str = ""
        # adaptive execution: the feedback store resolved at submit time,
        # the plan-cache key of the optimized entry, and the cardinalities
        # the plan was optimized under (store key -> believed rows); the
        # post-execution q-error check compares these against the fresh
        # observations and evicts the cached plan when they drifted
        self._feedback = None
        self._plan_key: str = ""
        self._est_map: Dict[str, int] = {}
        # inter-query batching: the extracted stacked-program membership
        # (core.batch.BatchShape) and the compatibility key the worker
        # groups on -- (interned program, device type); both None when
        # batching is off or the plan is ineligible
        self._batch_shape = None
        self._batch_key: Optional[tuple] = None
        self.submitted_at = time.perf_counter()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # same key shape as driver.empty_executor_stats() until the query
        # runs, so callers can index the dict without a done() check
        self.executor_stats: Dict[str, object] = empty_executor_stats()
        self._done = threading.Event()
        self._result: Optional[Dict] = None
        self._error: Optional[BaseException] = None

    # -- completion (scheduler side) ----------------------------------------
    def _complete(self, result=None, error=None) -> None:
        self._result, self._error = result, error
        self.finished_at = time.perf_counter()
        self._done.set()

    # -- consumption (client side) ------------------------------------------
    def done(self) -> bool:
        """True once the query finished (successfully or not)."""
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict:
        """Block until finished; return the collected columns dict.

        Re-raises the query's exception on failure; raises ``TimeoutError``
        if ``timeout`` (seconds) elapses first. The returned arrays may be
        shared with the result cache and coalesced handles -- treat them as
        read-only.
        """
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} still running after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-finish seconds (None while still running)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


class _VersionedLRU:
    """Bounded LRU whose entries carry a catalog-version snapshot.

    A lookup re-validates the snapshot against the live catalog; any bumped
    table version evicts the entry (re-registered table == new data).
    Internally locked: client threads get/put concurrently with workers.
    """

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 0)
        self._od: "OrderedDict[str, Tuple[tuple, object]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str, catalog):
        with self._lock:
            entry = self._od.get(key)
            if entry is not None:
                versions, value = entry
                if catalog.versions([n for n, _ in versions]) == versions:
                    self._od.move_to_end(key)
                    self.hits += 1
                    return value
                del self._od[key]       # stale: a table was re-registered
            self.misses += 1
            return None

    def put(self, key: str, versions: tuple, value) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._od[key] = (versions, value)
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)

    def invalidate(self, key: str) -> None:
        """Drop ``key`` if present."""
        with self._lock:
            self._od.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)


def referenced_tables(plan: P.PlanNode) -> List[str]:
    """Catalog tables a plan reads (cache-invalidation scope)."""
    names: List[str] = []

    def visit(node: P.PlanNode) -> None:
        if isinstance(node, P.TableScan):
            names.append(node.table)
        for c in node.children():
            visit(c)

    visit(plan)
    return sorted(set(names))


class QueryScheduler:
    """Admits, caches, and concurrently executes queries for one Session.

    Example (synchronous clients are threads; the scheduler interleaves
    their pipelines)::

        from repro_torch import SchedulerConfig, Session
        from repro_torch.tpch import dbgen, queries

        session = Session(dbgen.load_catalog(sf=0.01))
        session.scheduler_config = SchedulerConfig(memory_budget=256 << 20)
        handles = [session.submit(queries.build_query(q, session.catalog))
                   for q in (1, 6, 14)]
        results = session.gather(*handles)   # list of numpy dicts

    Thread-safe; one instance serves arbitrarily many client threads.
    """

    def __init__(self, session, config: Optional[SchedulerConfig] = None):
        self.session = session
        self.config = config or SchedulerConfig()
        self.plan_cache = _VersionedLRU(self.config.plan_cache_size)
        self.result_cache = _VersionedLRU(
            self.config.result_cache_size if self.config.cache_results else 0)
        self._cond = threading.Condition()
        self._pending: List[Tuple[int, int, QueryHandle]] = []   # heap
        self._mem_in_use = 0
        self._running = 0
        self._closed = False
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._threads: List[threading.Thread] = []
        # in-flight coalescing: key -> queued/running handle, so N
        # simultaneous identical queries execute once and share the result
        self._inflight: Dict[str, QueryHandle] = {}
        # served-query counters (exposed via stats())
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.coalesced = 0
        self.spill_admitted = 0
        self.batches = 0           # stacked launches (>= 2 members each)
        self.batched_queries = 0   # queries served via a stacked launch
        self.batch_fallbacks = 0   # stacked runs that raised (members solo)

    # -- public API ---------------------------------------------------------
    def submit(self, plan: P.PlanNode, priority: int = 0,
               sql: Optional[str] = None,
               num_workers: Optional[int] = None,
               optimize: Optional[bool] = None,
               feedback: Optional[object] = None,
               batching: Optional[bool] = None) -> QueryHandle:
        """Admit ``plan`` for execution; returns a ``QueryHandle``.

        Raises ``QueryRejected`` when the query could never fit (past the
        spill disk ceiling), or when the wait queue is full
        (backpressure). Higher ``priority`` dequeues first; ties run in
        submission order. A duplicate of an in-flight query coalesces onto
        its handle (raising that handle's queue priority if the duplicate's
        is higher).

        ``sql``, the text a SQL-born query was lowered from, prefixes both
        cache keys with ``sql=<sha1[:16]>:``: two texts that lower to the
        same plan share nothing, and the same plan without text keys
        apart. ``num_workers``/``optimize`` carry per-query ``ExecutionOptions``
        overrides: the worker count is pinned on the handle and keyed, and
        ``optimize=False`` runs the raw plan as-is. ``batching=False`` opts
        this query out of inter-query batching (it has no effect when the
        config flag is off). ``feedback`` is the query's store: None takes
        the session's, True an ephemeral one, False none, or a
        ``FeedbackStore`` as given.
        """
        device_type = self.session.device.type
        w = num_workers if num_workers is not None \
            else self.session.num_workers
        # adaptive execution: resolve the feedback store once, here, and
        # pin it on the handle (the per-query override, else the session's
        # store). True means an ephemeral per-query store; False disables
        # the session store for this query.
        if feedback is None:
            fb = self.session.feedback_store()
        elif feedback is True:
            from .feedback import FeedbackStore
            fb = FeedbackStore()
        elif feedback is False:
            fb = None
        else:
            fb = feedback
        # the device type stands where the reference keys on the kernel
        # backend
        # SQL-born queries prefix their cache keys with the text's hash,
        # so a change in the lowering of a text can never serve a result
        # cached under the old reading of it
        sql_prefix = ""
        if sql is not None:
            digest = hashlib.sha1(sql.encode("utf-8")).hexdigest()[:16]
            sql_prefix = f"sql={digest}:"
        # the feedback flag is part of the key: a warm (feedback-planned)
        # tree and the static plan of the same query differ, so neither
        # cache may serve one where the other was requested
        key = (f"{sql_prefix}w{w}:k={device_type}:fb{int(fb is not None)}:"
               f"{P.fingerprint(plan)}")
        # result cache first: a hit skips optimization entirely
        cached = self.result_cache.get(key, self.session.catalog)
        if cached is not None:
            handle = QueryHandle(next(self._ids), plan, priority, 0)
            handle.device_type = device_type
            handle.num_workers = w
            handle.cache_hit = True
            handle.started_at = time.perf_counter()
            handle._complete(result=cached)
            with self._cond:
                self.completed += 1
            return handle

        if optimize is False:
            optimized, est_map, plan_hit = plan, {}, False
        else:
            optimized, est_map, plan_hit = self._optimized(plan, key, w, fb)
        try:
            breakdown = estimate_memory_breakdown(
                optimized, self.session.catalog,
                num_workers=w,
                batch_rows=self.session.batch_rows,
                prefetch_depth=self.session.prefetch_depth,
                feedback=fb)
            est = breakdown.total
        except TypeError:
            if optimize is not False:
                raise
            # un-optimized plans may lack derived capacities; admit them
            # conservatively with no estimate rather than refuse
            breakdown, est = None, 0
        handle = QueryHandle(next(self._ids), optimized, priority,
                             min(est, self.config.memory_budget))
        handle.footprint = est
        handle.memory_breakdown = breakdown
        handle.plan_cache_hit = plan_hit
        handle.device_type = device_type
        handle.num_workers = w
        handle._feedback = fb
        handle._plan_key = "opt:" + key
        handle._est_map = est_map
        # version snapshot taken NOW: if a table is re-registered while the
        # query runs, the snapshot no longer matches at the next lookup and
        # the (stale) result is never served from cache
        handle._versions = self.session.catalog.versions(
            referenced_tables(optimized))

        if est > self.config.spill_disk_ceiling:
            with self._cond:
                self.rejected += 1
            raise QueryRejected(
                f"query footprint ~{est} B exceeds the scheduler's "
                f"memory budget of {self.config.memory_budget} B and the "
                f"spill disk ceiling of {self.config.spill_disk_ceiling} B; "
                f"raise SchedulerConfig.spill_disk_ceiling or shrink the "
                "query\n"
                + breakdown.describe(self.config.memory_budget,
                                     self.config.spill_host_budget))
        if est > self.config.memory_budget:
            handle.spill_plan = breakdown.spill_cost(
                self.config.memory_budget, self.config.spill_host_budget)
            with self._cond:
                self.spill_admitted += 1
        # inter-query batching: only when the config opts in (so the
        # disabled path never even inspects the plan), the query didn't
        # opt out, and the execution mode is the simple one a stacked
        # launch reproduces exactly -- optimized W=1 plan, no feedback
        # store (batched runs harvest no feedback), no spill
        mesh = self.session.mesh
        if (self.config.batching and batching is not False
                and optimize is not False and fb is None
                and handle.spill_plan is None and w == 1
                and (mesh is None or mesh.size == 1)):
            shape = _batch.extract_shape(optimized)
            if shape is not None:
                handle._batch_shape = shape
                handle._batch_key = (shape.program, device_type)
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self.config.cache_results:
                existing = self._inflight.get(key)
                if (existing is not None and not existing.done()
                        and self.session.catalog.versions(
                            [n for n, _ in existing._versions])
                        == existing._versions):
                    # identical query already queued/running against
                    # still-current table versions: share its handle; a
                    # more urgent duplicate promotes the queued entry. A
                    # version mismatch falls through to a fresh execution
                    # -- coalescing never serves stale data.
                    self.coalesced += 1
                    if priority > existing.priority:
                        existing.priority = priority
                        for i, (_, seq, h) in enumerate(self._pending):
                            if h is existing:
                                self._pending[i] = (-priority, seq, h)
                                heapq.heapify(self._pending)
                                break
                    return existing
            if len(self._pending) >= self.config.max_queue:
                self.rejected += 1
                raise QueryRejected(
                    f"wait queue full ({self.config.max_queue} queries); "
                    f"retry later (backpressure)")
            handle._result_key = key
            self._inflight[key] = handle
            heapq.heappush(self._pending,
                           (-priority, next(self._seq), handle))
            self._ensure_workers()
            self._cond.notify_all()
        return handle

    def gather(self, *handles: QueryHandle) -> List[Dict]:
        """Wait for every handle; returns results in argument order.

        Re-raises the first failed query's exception (after all have
        finished, so no work is silently abandoned).
        """
        for h in handles:
            h._done.wait()
        return [h.result() for h in handles]

    def run(self, plan: P.PlanNode, priority: int = 0) -> Dict:
        """Synchronous submit-and-wait (the serving path for one query)."""
        return self.submit(plan, priority).result()

    def stats(self) -> Dict[str, int]:
        """Served/rejected counters and cache hit/miss totals."""
        with self._cond:
            return {
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "coalesced": self.coalesced,
                "spill_admitted": self.spill_admitted,
                "batches": self.batches,
                "batched_queries": self.batched_queries,
                "batch_fallbacks": self.batch_fallbacks,
                "queued": len(self._pending),
                "running": self._running,
                "mem_in_use": self._mem_in_use,
                "plan_cache_hits": self.plan_cache.hits,
                "plan_cache_misses": self.plan_cache.misses,
                "result_cache_hits": self.result_cache.hits,
                "result_cache_misses": self.result_cache.misses,
            }

    def close(self, wait: bool = True) -> None:
        """Stop accepting queries; optionally wait for workers to drain
        (raises if a worker is still alive after 30 s)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=30.0)
            alive = [t.name for t in self._threads if t.is_alive()]
            if alive:
                raise RuntimeError(f"QueryScheduler.close: workers {alive} "
                                   "still running after 30 s")

    # -- internals ----------------------------------------------------------
    def _optimized(self, plan: P.PlanNode, raw_key: str, w: int,
                   fb: Optional[object]
                   ) -> Tuple[P.PlanNode, Dict[str, int], bool]:
        """Optimized plan via the plan cache. ``raw_key`` already carries
        the planned worker count (exchange placement makes the physical
        plan W-dependent), the device type, the feedback flag and the raw
        tree's fingerprint. Versions are snapshot *before* optimization,
        which reads catalog stats. Entries store ``(optimized, est_map)``
        where ``est_map`` is the per-node cardinality belief the plan was
        derived under (``optimizer.feedback_estimates``); the q-error
        check after execution compares it against fresh observations."""
        key = "opt:" + raw_key
        cached = self.plan_cache.get(key, self.session.catalog)
        if cached is not None:
            optimized, est_map = cached
            return optimized, est_map, True
        versions = self.session.catalog.versions(referenced_tables(plan))
        config = dataclasses.replace(self.session.optimizer_config(),
                                     num_workers=w, feedback=fb)
        optimized = optimize(plan, self.session.catalog, config=config)
        est_map = (feedback_estimates(optimized, self.session.catalog, config)
                   if fb is not None else {})
        self.plan_cache.put(key, versions, (optimized, est_map))
        return optimized, est_map, False

    def _ensure_workers(self) -> None:
        """Lazily grow the worker pool up to ``max_concurrency`` (held lock)."""
        alive = sum(1 for t in self._threads if t.is_alive())
        want = min(self.config.max_concurrency,
                   len(self._pending) + self._running)
        for i in range(alive, want):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"query-sched-{i}")
            t.start()
            self._threads.append(t)

    def _pick(self) -> Optional[QueryHandle]:
        """Highest-priority pending query that fits the remaining budget
        (held lock). Skipping an over-budget head is deadlock-free: when
        nothing is running the full budget is free, and every admitted
        estimate is capped at the budget. A head skipped
        ``max_head_skips`` times blocks further backfilling until it fits
        (the budget drains as running queries finish)."""
        if not self._pending:
            return None
        remaining = self.config.memory_budget - self._mem_in_use
        head = min(self._pending)               # heap order: priority, FIFO
        if head[2].estimate <= remaining:
            entry = head
        else:
            if head[2]._queue_skips >= self.config.max_head_skips:
                return None                     # drain until the head fits
            fits = [e for e in self._pending if e[2].estimate <= remaining]
            if not fits:
                return None
            # the head is genuinely passed over for a smaller query: only
            # real backfills age it, not idle worker polls
            head[2]._queue_skips += 1
            entry = min(fits)
        self._pending.remove(entry)
        heapq.heapify(self._pending)
        return entry[2]

    def _worker(self) -> None:
        while True:
            with self._cond:
                handle = self._pick()
                while handle is None:
                    if self._closed and not self._pending:
                        return
                    self._cond.wait(timeout=0.1)
                    handle = self._pick()
                self._mem_in_use += handle.estimate
                self._running += 1
                members = [handle]
                if self.config.batching and handle._batch_key is not None:
                    members += self._claim_batch(handle)
            try:
                if len(members) > 1:
                    self._execute_batch(members)
                else:
                    self._execute(handle)
            finally:
                with self._cond:
                    for m in members:
                        self._mem_in_use -= m.estimate
                        self._running -= 1
                        if self._inflight.get(m._result_key) is m:
                            del self._inflight[m._result_key]
                    self._cond.notify_all()

    def _claim_batch(self, leader: QueryHandle) -> List[QueryHandle]:
        """Claim pending queries compatible with ``leader`` for one stacked
        launch (held lock). Compatibility is the leader's batch key -- the
        interned program (which encodes table, columns, stage shape,
        aggregation, and W=1) plus the device type -- and an identical
        catalog-version snapshot, so a batch never mixes data generations.
        The worker waits up to ``batch_window_ms`` for stragglers; a keyed
        aggregation caps the batch at ``stacked_group_capacity`` (a query
        whose ``max_groups`` alone exceeds it runs solo). Claimed members
        charge their full admission estimates -- a conservative
        over-charge, since the stacked run shares one scan."""
        limit = self._batch_limit(leader._batch_shape.program)
        members: List[QueryHandle] = []
        deadline = time.perf_counter() + self.config.batch_window_ms / 1000.0
        while True:
            if len(members) + 1 < limit:
                claimed = []
                for entry in self._pending:
                    h = entry[2]
                    if (h._batch_key == leader._batch_key
                            and h._versions == leader._versions):
                        claimed.append(entry)
                        if len(members) + 1 + len(claimed) >= limit:
                            break
                for entry in claimed:
                    self._pending.remove(entry)
                    h = entry[2]
                    self._mem_in_use += h.estimate
                    self._running += 1
                    members.append(h)
                if claimed:
                    heapq.heapify(self._pending)
            if len(members) + 1 >= limit:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            # releases the lock: submits land while we wait, and the loop
            # top sweeps them up (one final sweep after the window closes)
            self._cond.wait(remaining)
        return members

    def _batch_limit(self, program) -> int:
        """Per-program member cap for one stacked execution: ``max_batch``,
        tightened for keyed aggregations to ``stacked_group_capacity`` (the
        reference's bound, a batch-size policy in the port).
        ``fused_batch_program`` takes any number of lanes."""
        limit = self.config.max_batch
        if program.group_keys:
            limit = min(limit,
                        _segagg.stacked_group_capacity(program.max_groups))
        return limit

    def _context(self, handle: QueryHandle):
        sess = self.session
        if handle.num_workers != sess.num_workers:
            # per-query worker-count override: a session clone, so the
            # context matches the W the plan was optimized for (on a mesh
            # the clone checks that the mesh splits that W, else raises
            # ValueError into the handle)
            sess = dataclasses.replace(sess, num_workers=handle.num_workers)
        # each context clones the exchange; the store is the one resolved
        # at submit time (None for every batched member)
        return dataclasses.replace(sess.context(), feedback=handle._feedback)

    def _execute_batch(self, members: List[QueryHandle]) -> None:
        """Run a claimed group as ONE stacked execution, scattering the
        per-member results (and stats) back onto each handle. A stacked
        failure falls back to per-member solo execution -- a query that
        would succeed alone never receives a batched error -- and is
        recorded: ``batch_fallbacks`` in ``stats()`` and the error's text
        on each member's ``executor_stats["batch"]["fallback"]``."""
        t_launch = time.perf_counter()
        for m in members:
            m.started_at = t_launch
        try:
            driver = Driver(self._context(members[0]))
            # lanes: the claimed size rounded up to a power of two; the
            # lowered program does not depend on it (the reference pins
            # the per-program cap so one jitted executable serves every
            # size)
            results = driver.collect_batch([m._batch_shape for m in members])
        except Exception as exc:  # noqa: BLE001 -- the members run solo
            with self._cond:
                self.batch_fallbacks += 1
            info = {"size": len(members),
                    "fallback": f"{type(exc).__name__}: {exc}"}
            for m in members:
                self._execute(m, batch_info=info)
            return
        stats = driver.executor_stats()
        for m, result in zip(members, results):
            es = dict(stats)
            es["batch"] = {"size": len(members),
                           "queue_delay_s": t_launch - m.submitted_at}
            m.executor_stats = es
            self.result_cache.put(m._result_key, m._versions, result)
            m._complete(result=result)
        with self._cond:
            self.completed += len(members)
            self.batches += 1
            self.batched_queries += len(members)

    def _execute(self, handle: QueryHandle,
                 batch_info: Optional[Dict] = None) -> None:
        """Run one admitted query on this worker thread's own Driver.
        ``batch_info`` (a stacked run's fallback record) joins the
        handle's ``executor_stats`` under ``"batch"``."""
        handle.started_at = time.perf_counter()
        try:
            ctx = self._context(handle)
            if handle.spill_plan is not None and ctx.spill is None:
                # admitted over budget: run under a per-query spill
                # manager whose device budget is the scheduler's whole
                # budget (the query charged all of it, so it runs alone);
                # each partition it spills comes back on the card it left
                from .spill import SpillManager
                ctx = dataclasses.replace(ctx, spill=SpillManager(
                    self.config.memory_budget,
                    self.config.spill_host_budget,
                    spill_dir=self.config.spill_dir,
                    disk_ceiling=self.config.spill_disk_ceiling,
                    device=ctx.device))
            driver = Driver(ctx)
            result = driver.collect(handle.plan)
            stats = driver.executor_stats()
            if batch_info is not None:
                stats["batch"] = dict(batch_info)
            handle.executor_stats = stats
            self._check_feedback(handle)
            self.result_cache.put(handle._result_key, handle._versions,
                                  result)
            handle._complete(result=result)
            with self._cond:
                self.completed += 1
        except BaseException as exc:  # noqa: BLE001 -- delivered via handle
            if batch_info is not None:
                handle.executor_stats = dict(handle.executor_stats,
                                             batch=dict(batch_info))
            handle._complete(error=exc)
            with self._cond:
                self.failed += 1
            if not isinstance(exc, Exception):
                raise

    def _check_feedback(self, handle: QueryHandle) -> None:
        """Adaptive plan-cache invalidation: after a feedback-enabled
        query runs, compare the cardinalities its cached plan was derived
        under (``handle._est_map``) against the observations the driver
        just harvested. A q-error past ``feedback_qerror_limit`` on any
        node means the plan's capacities and ordering were priced from
        stale beliefs: evict the entry so the next identical submit
        re-plans from the updated store. Warm (feedback-planned) entries
        have estimate == observation and survive, so the loop converges."""
        fb = handle._feedback
        if fb is None or not handle._est_map:
            return
        worst = 1.0
        for key, est in handle._est_map.items():
            entry = fb.get(key)
            if entry is not None:
                worst = max(worst, qerror(est, entry.rows))
        if worst > self.config.feedback_qerror_limit:
            self.plan_cache.invalidate(handle._plan_key)
