"""The PyTorch port's query scheduler (``repro_torch.core.scheduler``):
the reference's tier-1 scheduler tests (``tests/test_scheduler.py``) on the
port's ``Session(device="cpu")`` -- admission, backpressure, priority, both
caches, re-registration, coalescing, interleaved correctness against the
oracle, failure delivery -- plus the admission estimate held byte for byte
to the reference's for all 22 optimized TPC-H plans at W=1 and W=4, and
the reference's admit-with-spill test: an over-budget query runs out of
core under a per-query spill manager."""

import threading
import time

import numpy as np
import pytest

from repro.core.optimizer import (
    estimate_memory_breakdown as ref_estimate_breakdown)
from repro.tpch import dbgen as ref_dbgen
from repro.tpch import oracle
from repro.tpch import queries as ref_queries

from torch_diff import port_catalog
from tpch_util import assert_results_match

from repro_torch import ExecutionOptions, QueryRejected, SchedulerConfig
from repro_torch.core import dtypes as dt
from repro_torch.core import plan as P
from repro_torch.core.optimizer import (estimate_memory,
                                        estimate_memory_breakdown)
from repro_torch.core.session import InMemoryTable, Session
from repro_torch.tpch import queries, schema as S

SF = 0.002


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=SF)


@pytest.fixture()
def catalog(data):
    # function-scoped: tests mutate the catalog (re-registration)
    return port_catalog(data)


def _session(catalog, **kw):
    return Session(catalog, device="cpu", **kw)


class GatedTable(InMemoryTable):
    """InMemoryTable whose scan blocks until ``gate`` is set (lets tests
    hold a query 'running' deterministically)."""

    def __init__(self, name, data, schema, gate):
        super().__init__(name, data, schema)
        self.gate = gate

    def _host_morsels(self, *args, **kwargs):
        assert self.gate.wait(timeout=30.0), "test gate never opened"
        yield from super()._host_morsels(*args, **kwargs)


def _tiny_table(catalog, name, gate=None):
    data = {"k": np.arange(8, dtype=np.int32),
            "v": np.ones(8, dtype=np.float32)}
    schema = {"k": dt.INT32, "v": dt.FLOAT32}
    if gate is None:
        catalog.register(InMemoryTable(name, data, schema))
    else:
        catalog.register(GatedTable(name, data, schema, gate))


def _wait_until_running(session, n: int, timeout: float = 10.0) -> None:
    """Spin until ``n`` queries are actively running (past the queue)."""
    deadline = time.monotonic() + timeout
    while session.scheduler().stats()["running"] < n:
        assert time.monotonic() < deadline, "query never started running"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_over_disk_ceiling_query_rejected(catalog):
    session = _session(catalog)
    session.scheduler_config = SchedulerConfig(memory_budget=1024,
                                               spill_disk_ceiling=1024)
    with pytest.raises(QueryRejected, match="memory budget") as ei:
        session.submit(queries.build_query(1, catalog))
    msg = str(ei.value)
    assert "TableScan(lineitem)" in msg and "spill cost" in msg
    assert session.scheduler().stats()["rejected"] == 1


def test_over_budget_query_admitted_with_spill(catalog, data):
    # over the memory budget but under the disk ceiling: admitted with a
    # priced slowdown and executed out-of-core (nonzero spilled bytes)
    session = _session(catalog, batch_rows=4096)
    session.scheduler_config = SchedulerConfig(memory_budget=64 * 1024)
    handle = session.submit(queries.build_query(3, catalog))
    assert handle.spill_plan is not None
    assert handle.spill_plan["excess_bytes"] > 0
    assert handle.spill_plan["est_slowdown"] > 1.0
    assert handle.memory_breakdown.total == handle.footprint
    assert handle.estimate == 64 * 1024    # charged the whole budget
    res = handle.result(timeout=300)
    assert_results_match(res, oracle.ORACLES[3](data), 3)
    stats = session.scheduler().stats()
    assert stats["spill_admitted"] == 1 and stats["rejected"] == 0
    spill = handle.executor_stats.get("spill", {})
    assert spill.get("spilled_bytes", 0) > 0


def test_queue_full_backpressure(catalog):
    gate = threading.Event()
    _tiny_table(catalog, "gated", gate=gate)
    session = _session(catalog)
    session.scheduler_config = SchedulerConfig(
        max_concurrency=1, max_queue=1, cache_results=False)
    try:
        running = session.submit(P.TableScan("gated"))
        _wait_until_running(session, 1)
        queued = session.submit(P.Limit(P.TableScan("gated"), 1))
        with pytest.raises(QueryRejected, match="queue full"):
            session.submit(P.Limit(P.TableScan("gated"), 2))
    finally:
        gate.set()
    assert len(session.gather(running, queued)) == 2
    assert session.scheduler().stats()["rejected"] == 1


def test_priority_orders_the_wait_queue(catalog):
    gate = threading.Event()
    _tiny_table(catalog, "gated", gate=gate)
    _tiny_table(catalog, "plain")
    session = _session(catalog)
    session.scheduler_config = SchedulerConfig(
        max_concurrency=1, cache_results=False)
    try:
        blocker = session.submit(P.TableScan("gated"))
        _wait_until_running(session, 1)
        low = session.submit(P.Limit(P.TableScan("plain"), 1), priority=0)
        high = session.submit(P.Limit(P.TableScan("plain"), 2), priority=5)
    finally:
        gate.set()
    session.gather(blocker, low, high)
    assert high.started_at < low.started_at, \
        "higher-priority query should leave the queue first"


def test_memory_estimate_scales_with_plan(catalog):
    scan = P.TableScan("lineitem")
    joined = P.Join(probe=scan, build=P.TableScan("orders"),
                    probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
                    build_payload=["o_orderdate"])
    e_scan = estimate_memory(scan, catalog)
    e_join = estimate_memory(joined, catalog)
    assert 0 < e_scan < e_join, (e_scan, e_join)


@pytest.mark.parametrize("workers", [1, 4])
def test_memory_breakdown_matches_reference(workers, data):
    """Label by label and byte by byte, for all 22 optimized plans."""
    ref_cat = ref_dbgen.load_catalog(sf=SF)
    cat = port_catalog(data)
    for q in range(1, 23):
        want = ref_estimate_breakdown(
            ref_queries.build_query(q, ref_cat, num_workers=workers), ref_cat,
            num_workers=workers, batch_rows=8192, prefetch_depth=2)
        got = estimate_memory_breakdown(
            queries.build_query(q, cat, num_workers=workers), cat,
            num_workers=workers, batch_rows=8192, prefetch_depth=2)
        assert got.per_node == want.per_node, f"Q{q} W={workers}"
        assert got.total == want.total, f"Q{q} W={workers}"
        assert got.describe(1 << 20) == want.describe(1 << 20)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def test_result_cache_serves_repeats(catalog):
    session = _session(catalog)
    first = session.submit(queries.build_query(6, catalog, optimized=False))
    first.result(timeout=60)
    repeat = session.submit(queries.build_query(6, catalog, optimized=False))
    assert repeat.cache_hit
    np.testing.assert_array_equal(repeat.result()["revenue"],
                                  first.result()["revenue"])
    stats = session.scheduler().stats()
    assert stats["result_cache_hits"] == 1
    # a result-cache hit short-circuits before optimization
    assert stats["plan_cache_hits"] == 0


def test_plan_cache_skips_reoptimization(catalog):
    session = _session(catalog)
    session.scheduler_config = SchedulerConfig(cache_results=False)
    for _ in range(2):
        session.submit(queries.build_query(6, catalog,
                                           optimized=False)).result(timeout=60)
    stats = session.scheduler().stats()
    assert stats["plan_cache_hits"] == 1 and stats["result_cache_hits"] == 0


def test_result_cache_invalidated_by_reregistration(catalog, data):
    session = _session(catalog)
    plan = queries.build_query(6, catalog, optimized=False)
    session.run(plan)
    assert session.submit(plan).cache_hit

    # re-register lineitem with the first 100 rows: new table version, so
    # the cached (full-table) result must NOT be served
    small = {k: v[:100] for k, v in data["lineitem"].items()}
    catalog.register_numpy("lineitem", small, S.SCHEMAS["lineitem"])
    handle = session.submit(plan)
    assert not handle.cache_hit, "stale result served after re-registration"
    handle.result(timeout=60)

    small_oracle = oracle.ORACLES[6]({**data, "lineitem": small})
    np.testing.assert_allclose(
        np.asarray(handle.result()["revenue"], dtype=np.float64).reshape(()),
        np.asarray(small_oracle["revenue"], dtype=np.float64).reshape(()),
        rtol=2e-3, atol=1e-2)


def test_midquery_reregistration_does_not_poison_cache(catalog):
    """A table re-registered while a query over it runs must invalidate
    that query's cached result (admission-time version snapshot)."""
    gate = threading.Event()
    _tiny_table(catalog, "gated", gate=gate)
    session = _session(catalog)
    running = session.submit(P.TableScan("gated"))
    _wait_until_running(session, 1)
    catalog.register_numpy("gated", {"k": np.arange(3, dtype=np.int32),
                                     "v": np.ones(3, dtype=np.float32)},
                           {"k": dt.INT32, "v": dt.FLOAT32})
    # an identical submit now must NOT coalesce onto the v1 execution
    dup = session.submit(P.TableScan("gated"))
    assert dup is not running, "coalesced onto a stale in-flight query"
    assert len(dup.result(timeout=30)["k"]) == 3
    gate.set()
    old = running.result(timeout=30)
    assert len(old["k"]) == 8              # ran against the old table
    fresh = session.submit(P.TableScan("gated"))
    assert not fresh.cache_hit, "stale mid-query result served from cache"
    assert len(fresh.result(timeout=30)["k"]) == 3


def test_inflight_duplicates_coalesce(catalog):
    gate = threading.Event()
    _tiny_table(catalog, "gated", gate=gate)
    session = _session(catalog)
    session.scheduler_config = SchedulerConfig(max_concurrency=1)
    try:
        a = session.submit(P.TableScan("gated"))
        b = session.submit(P.TableScan("gated"))
    finally:
        gate.set()
    assert a is b, "identical in-flight queries should share one handle"
    assert session.scheduler().stats()["coalesced"] == 1
    a.result(timeout=30)


def test_fingerprint_canonicalizes_sequences():
    a = P.TableScan("lineitem", columns=["l_quantity", "l_discount"])
    b = P.TableScan("lineitem", columns=("l_quantity", "l_discount"))
    c = P.TableScan("lineitem", columns=["l_discount", "l_quantity"])
    assert P.fingerprint(a) == P.fingerprint(b)
    assert P.fingerprint(a) != P.fingerprint(c)


# ---------------------------------------------------------------------------
# interleaved execution correctness
# ---------------------------------------------------------------------------

def test_interleaved_q1_q6_oracle_correct(catalog, data):
    """4 concurrent Q1/Q6 queries (caching off: four real executions whose
    morsel pipelines interleave) all produce oracle-correct results."""
    session = _session(catalog, batch_rows=8192)
    session.scheduler_config = SchedulerConfig(
        max_concurrency=4, cache_results=False)
    plans = [queries.build_query(q, catalog, optimized=False)
             for q in (1, 6, 1, 6)]
    handles = [session.submit(p) for p in plans]
    results = session.gather(*handles)
    for qnum, res in zip((1, 6, 1, 6), results):
        assert_results_match(res, oracle.ORACLES[qnum](data), qnum)
    stats = session.scheduler().stats()
    assert stats["completed"] == 4 and stats["failed"] == 0
    assert all(h.executor_stats["device"] == "cpu" for h in handles)


class FailingTable(InMemoryTable):
    """Table whose scan raises mid-read (storage failure injection)."""

    def _host_morsels(self, *args, **kwargs):
        raise RuntimeError("disk on fire")
        yield  # pragma: no cover -- makes this a generator


def test_failed_query_raises_through_handle(catalog):
    catalog.register(FailingTable("flaky", {"k": np.arange(8, dtype=np.int32)},
                                  {"k": dt.INT32}))
    session = _session(catalog)
    # a failure inside the worker thread must surface through the handle,
    # not kill the scheduler (the next query still runs)
    bad = session.submit(P.TableScan("flaky"))
    with pytest.raises(RuntimeError, match="disk on fire"):
        bad.result(timeout=60)
    ok = session.submit(P.Limit(P.TableScan("orders"), 1))
    assert len(next(iter(ok.result(timeout=60).values()))) == 1
    stats = session.scheduler().stats()
    assert stats["failed"] == 1 and stats["completed"] == 1


def test_builder_submit_and_per_query_workers(catalog, data):
    """``QueryBuilder.submit`` routes through the scheduler, and a per-query
    worker count plans and runs the query for that W (its own cache key)."""
    session = _session(catalog)
    q6 = queries.build_query(6, catalog, optimized=False)
    w1 = session.table("orders").limit(3).submit()
    assert len(w1.result(timeout=60)["o_orderkey"]) == 3
    w4 = session.submit(q6, options=ExecutionOptions(num_workers=4))
    w1 = session.submit(q6)
    assert w4.num_workers == 4 and w1.num_workers == 1
    assert not w1.cache_hit                 # W is part of the key
    for h in (w4, w1):
        assert_results_match(h.result(timeout=60), oracle.ORACLES[6](data), 6)
    assert session.scheduler().stats()["failed"] == 0
