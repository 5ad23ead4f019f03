"""The port's adaptive execution (``repro_torch.core.feedback``), the
counterparts of the tier-1 tests of ``tests/test_feedback.py`` on the CPU
at SF 0.002: q-error algebra, capacity-normalized ``feedback_key``, store
bucketing and bookkeeping, the executor-stats shape, warm bounds sound and
tight for Q3/Q5/Q10, feedback off inert, the scheduler's q-error eviction
and convergence, and static plans staying cached. Also: the observation
keeps its counts on the device until one read-back per query."""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import ints, seeded_given  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro_torch.core import driver as port_driver  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.driver import empty_executor_stats  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.core.feedback import (FeedbackStore, qerror,  # noqa: E402
                                       referenced_sources)
from repro_torch.core.optimizer import (estimate_memory,  # noqa: E402
                                        optimize)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.tpch import dbgen, oracle, queries  # noqa: E402

SF = 0.002


@functools.lru_cache(maxsize=1)
def dataset():
    """(raw numpy tables, catalog) at SF, cached."""
    return dbgen.generate(sf=SF), dbgen.load_catalog(sf=SF)


def _session(catalog, **kw) -> Session:
    return Session(catalog, device="cpu", **kw)


# ---------------------------------------------------------------------------
# q-error algebra
# ---------------------------------------------------------------------------

@seeded_given(max_examples=50, est=ints(0, 1 << 20), obs=ints(0, 1 << 20))
def test_qerror_symmetric_and_bounded(est, obs):
    q = qerror(est, obs)
    assert q == qerror(obs, est)
    assert q >= 1.0
    if max(est, 1) == max(obs, 1):
        assert q == 1.0
    else:
        assert q > 1.0


@seeded_given(max_examples=50, obs=ints(1, 1 << 16), lo=ints(0, 1 << 10),
              hi=ints(0, 1 << 10))
def test_qerror_monotone_in_overestimate(obs, lo, hi):
    a, b = sorted((obs + lo, obs + lo + hi))
    assert qerror(a, obs) <= qerror(b, obs)
    a, b = sorted((max(obs - lo, 1), max(obs - lo - hi, 1)), reverse=True)
    assert qerror(a, obs) <= qerror(b, obs)


def test_qerror_floors_zero_rows():
    assert qerror(0, 0) == 1.0
    assert qerror(0, 10) == 10.0
    assert qerror(10, 0) == 10.0


# ---------------------------------------------------------------------------
# capacity-normalized plan keys
# ---------------------------------------------------------------------------

def _scan():
    return P.TableScan("lineitem", columns=("l_orderkey", "l_quantity"))


def test_feedback_key_ignores_derived_capacities():
    agg = P.Aggregation(_scan(), ["l_orderkey"], [("n", "count", None)])
    resized = P.Aggregation(_scan(), ["l_orderkey"], [("n", "count", None)],
                            max_groups=1 << 20, mode="partial")
    assert P.feedback_key(agg) == P.feedback_key(resized)
    assert P.fingerprint(agg) != P.fingerprint(resized)
    other_key = P.Aggregation(_scan(), ["l_quantity"],
                              [("n", "count", None)])
    assert P.feedback_key(agg) != P.feedback_key(other_key)

    probe = P.TableScan("lineitem", columns=("l_orderkey",))
    build = P.TableScan("orders", columns=("o_orderkey",))
    join = P.Join(probe, build, ["l_orderkey"], ["o_orderkey"])
    sized = P.Join(probe, build, ["l_orderkey"], ["o_orderkey"],
                   max_matches=7, distribution="partitioned",
                   build_rows=123)
    assert P.feedback_key(join) == P.feedback_key(sized)
    semi = P.Join(probe, build, ["l_orderkey"], ["o_orderkey"],
                  join_type="left_semi")
    assert P.feedback_key(join) != P.feedback_key(semi)


def test_feedback_key_looks_through_exchanges():
    agg = P.Aggregation(_scan(), ["l_orderkey"], [("n", "count", None)])
    assert P.feedback_key(P.Repartition(agg, ["l_orderkey"])) \
        == P.feedback_key(agg)
    assert P.feedback_key(P.Broadcast(P.Repartition(agg, ["l_orderkey"]),
                                      num_workers=2)) == P.feedback_key(agg)
    probe = P.TableScan("lineitem", columns=("l_orderkey",))
    build = P.TableScan("orders", columns=("o_orderkey",))
    wrapped = P.Join(probe, P.Broadcast(build, num_workers=2),
                     ["l_orderkey"], ["o_orderkey"])
    bare = P.Join(probe, build, ["l_orderkey"], ["o_orderkey"])
    assert P.feedback_key(wrapped) == P.feedback_key(bare)


def test_feedback_key_stable_across_equivalent_plans():
    def build():
        return P.Aggregation(
            P.Filter(_scan(), col("l_quantity") < 10.0),
            ["l_orderkey"], [("s", "sum", "l_quantity")])
    assert P.feedback_key(build()) == P.feedback_key(build())


@pytest.mark.parametrize("q", [3, 9, 18])
def test_fingerprint_unchanged_by_the_node_fn(q):
    """``_canon``'s recursion argument leaves ``fingerprint`` as it was:
    the default recursion is ``fingerprint`` itself."""
    _, catalog = dataset()
    plan = queries.build_query(q, catalog)
    assert P._canon(plan) == P.fingerprint(plan)
    assert P._canon(plan, P.feedback_key) == P.feedback_key(plan)


# ---------------------------------------------------------------------------
# store bucketing and bookkeeping
# ---------------------------------------------------------------------------

def test_store_buckets_workers_and_versions():
    _, catalog = dataset()
    fb = FeedbackStore()
    agg = P.Aggregation(_scan(), ["l_orderkey"], [("n", "count", None)])
    assert referenced_sources(agg) == ("lineitem",)
    k1 = fb.key_for(agg, catalog, 1)
    assert k1 == f"w1|{catalog.versions(['lineitem'])!r}|{P.feedback_key(agg)}"
    assert k1 != fb.key_for(agg, catalog, 2)
    fb.record(k1, rows=42, estimated=100)
    catalog.register(catalog.get("lineitem"))   # version bump, same data
    try:
        k1b = fb.key_for(agg, catalog, 1)
        assert k1b != k1
        assert fb.rows(k1b) is None             # stale entry no longer matches
        assert fb.rows(k1) == 42
    finally:
        dataset.cache_clear()                   # later tests: version 1


def test_store_record_and_summary():
    fb = FeedbackStore()
    e = fb.record("k", rows=10, estimated=100)
    assert e.qerror == 10.0
    fb.record("k", rows=20, max_matches=3, skip_fraction=0.5)
    entry = fb.get("k")
    assert (entry.rows, entry.max_matches, entry.skip_fraction,
            entry.updates) == (20, 3, 0.5, 2)
    assert fb.get("k").hits == 0
    assert fb.rows("k") == 20
    assert fb.max_matches("k") == 3 and fb.skip_fraction("k") == 0.5
    s = fb.summary()
    assert s["entries"] == 1 and s["updates"] == 2 and s["hits"] == 1
    assert s["max_qerror"] == pytest.approx(qerror(100, 10))
    fb.clear()
    assert len(fb) == 0


# ---------------------------------------------------------------------------
# executor_stats shape
# ---------------------------------------------------------------------------

def test_executor_stats_shape_before_any_query():
    _, catalog = dataset()
    shape = set(empty_executor_stats())
    assert "feedback" in shape
    session = _session(catalog)
    assert set(session.executor_stats()) == shape
    handle = session.submit(queries.build_query(6, catalog))
    assert set(handle.executor_stats) == shape     # possibly still queued
    handle.result()
    assert set(handle.executor_stats) == shape
    session.execute(session.optimize(queries.build_query(6, catalog)))
    assert set(session.executor_stats()) == shape
    session.reset_scheduler()


def test_executor_stats_feedback_summary():
    _, catalog = dataset()
    session = _session(catalog, feedback=True)
    assert session.executor_stats()["feedback"]["entries"] == 0
    session.execute(session.optimize(queries.build_query(6, catalog)))
    assert session.executor_stats()["feedback"]["entries"] > 0
    plain = _session(catalog)
    plain.execute(plain.optimize(queries.build_query(6, catalog)))
    assert plain.executor_stats()["feedback"] == {}


# ---------------------------------------------------------------------------
# warm bounds are sound and tighter, results identical
# ---------------------------------------------------------------------------

def _agg_bounds(plan):
    out = []

    def visit(node):
        if isinstance(node, (P.Aggregation, P.Distinct)):
            out.append((node, node.max_groups))
        for c in node.children():
            visit(c)

    visit(plan)
    return out


@pytest.mark.parametrize("qnum", [3, 5, 10])
def test_warm_bounds_sound_and_tight(qnum):
    data, catalog = dataset()
    session = _session(catalog, feedback=True)
    fb = session.feedback_store()
    q = queries.build_query(qnum, catalog, optimized=False)
    cold_plan = session.optimize(q)
    assert P.fingerprint(cold_plan) == P.fingerprint(
        queries.build_query(qnum, catalog))
    cold = session.execute(cold_plan)
    warm_plan = session.optimize(q)
    warm = session.execute(warm_plan)

    assert_results_match(warm, cold, qnum)
    assert_results_match(warm, oracle.ORACLES[qnum](data), qnum)

    static = dict((P.feedback_key(n), mg) for n, mg in _agg_bounds(cold_plan))
    checked = 0
    for node, warm_mg in _agg_bounds(warm_plan):
        observed = fb.rows(fb.key_for(node, catalog, 1))
        if observed is None:
            continue
        checked += 1
        assert warm_mg >= observed, (qnum, warm_mg, observed)
        assert warm_mg <= static[P.feedback_key(node)]
    assert checked > 0, f"q{qnum}: no aggregation bound was re-derived"
    # the warm plan prices at most what the cold one does
    assert estimate_memory(warm_plan, catalog, feedback=fb) \
        <= estimate_memory(cold_plan, catalog)


def test_feedback_off_is_inert():
    _, catalog = dataset()
    session = _session(catalog)
    q = queries.build_query(3, catalog, optimized=False)
    p1 = session.optimize(q)
    session.execute(p1)
    assert session.last_driver._feedback_obs == []
    p2 = session.optimize(q)
    assert session.feedback_store() is None
    assert P.fingerprint(p1) == P.fingerprint(p2)


def test_feedback_option_overrides_the_session():
    """``ExecutionOptions.feedback``: False turns the session's store off
    for one query, a store is used as given."""
    from repro_torch.core.session import ExecutionOptions
    _, catalog = dataset()
    session = _session(catalog, feedback=True)
    off = session._with_options(ExecutionOptions(feedback=False))
    assert off.feedback_store() is None
    mine = FeedbackStore()
    assert session._with_options(
        ExecutionOptions(feedback=mine)).feedback_store() is mine
    assert session.feedback_store() is not mine


# ---------------------------------------------------------------------------
# the observation: counts on the device, one read-back per query
# ---------------------------------------------------------------------------

def test_observation_reads_back_once_per_query(monkeypatch):
    _, catalog = dataset()
    session = _session(catalog, feedback=True, batch_rows=1024)
    seen = {}
    harvest = port_driver.Driver._harvest_feedback
    reads = []
    stack = torch.stack

    def counted_stack(tensors, *a, **kw):
        out = stack(tensors, *a, **kw)
        tolist = out.tolist
        reads.append(len(tensors))
        return type("Once", (), {"tolist": staticmethod(tolist)})()

    def spy(self):
        # every count is still a 0-d int64 tensor on the session's device
        seen["counts"] = [c for _, c, _ in self._feedback_obs]
        seen["matches"] = list(self._feedback_matches.values())
        monkeypatch.setattr(port_driver.torch, "stack", counted_stack)
        try:
            harvest(self)
        finally:
            monkeypatch.setattr(port_driver.torch, "stack", stack)

    monkeypatch.setattr(port_driver.Driver, "_harvest_feedback", spy)
    session.execute(session.optimize(queries.build_query(18, catalog)))
    assert seen["counts"] and seen["matches"]
    for t in seen["counts"] + seen["matches"]:
        assert isinstance(t, torch.Tensor) and t.dim() == 0
        assert t.dtype == torch.int64 and t.device == session.device
    assert reads == [len(seen["counts"]) + len(seen["matches"])]


def test_build_multiplicity_matches_numpy():
    """The device-side multiplicity (sort and run lengths over the valid
    keys, dead rows under a key no int32 takes) equals ``np.unique``'s
    largest count, and 1 for an empty build."""
    from repro_torch.core import dtypes as dt
    from repro_torch.core.table import TorchTable
    rng = np.random.default_rng(7)
    drv = port_driver.Driver(port_driver.ExecutionContext(
        catalog=None, device=torch.device("cpu")))
    node = P.Join(P.TableScan("a"), P.TableScan("b"), ["k"], ["k"])
    for n, hi, p in [(1000, 50, 0.7), (1000, 2000, 0.9), (64, 3, 0.0),
                     (0, 1, 1.0), (300, 1 << 30, 1.0)]:
        keys = rng.integers(-hi, hi, n).astype(np.int32)
        valid = rng.random(n) < p
        t = TorchTable({"k": torch.from_numpy(keys)},
                       torch.from_numpy(valid), {"k": dt.INT32})
        drv._observe_join_build(node, [t], "partitioned")
        got = int(drv._feedback_matches[id(node)])
        vals = keys[valid]
        want = 1 if vals.size == 0 else int(
            np.unique(vals, return_counts=True)[1].max())
        assert got == want, (n, hi, p)


# ---------------------------------------------------------------------------
# scheduler plan-cache q-error eviction and convergence
# ---------------------------------------------------------------------------

def test_scheduler_replans_then_converges():
    _, catalog = dataset()
    session = _session(
        catalog, feedback=True,
        scheduler_config=SchedulerConfig(cache_results=False))
    q = queries.build_query(3, catalog, optimized=False)
    try:
        h1 = session.submit(q)
        h1.result()
        h2 = session.submit(q)
        h2.result()
        h3 = session.submit(q)
        h3.result()
        assert not h1.plan_cache_hit
        assert not h2.plan_cache_hit       # cold entry was q-error-evicted
        assert h3.plan_cache_hit           # warm entry converged and stays
        assert h1._est_map and h2._est_map
        assert_results_match(h2.result(), h1.result(), 3)
        assert_results_match(h3.result(), h1.result(), 3)
    finally:
        session.reset_scheduler()


def test_scheduler_static_plans_stay_cached():
    _, catalog = dataset()
    session = _session(
        catalog, scheduler_config=SchedulerConfig(cache_results=False))
    q = queries.build_query(3, catalog, optimized=False)
    try:
        h1 = session.submit(q)
        h1.result()
        h2 = session.submit(q)
        h2.result()
        assert not h1.plan_cache_hit
        assert h2.plan_cache_hit
        assert h1._est_map == {} == h2._est_map
    finally:
        session.reset_scheduler()


def test_scheduler_never_batches_a_query_with_a_store():
    _, catalog = dataset()
    session = _session(
        catalog, feedback=True,
        scheduler_config=SchedulerConfig(batching=True, cache_results=False))
    try:
        handles = [session.submit(queries.build_query(6, catalog))
                   for _ in range(4)]
        session.gather(*handles)
        assert all(h._batch_key is None for h in handles)
        assert session.scheduler().stats()["batches"] == 0
    finally:
        session.reset_scheduler()


def test_warm_plan_optimizes_like_the_session():
    """``optimize`` with a config that carries the store is what the
    session's ``optimize`` runs (the scheduler and the direct path plan
    alike)."""
    _, catalog = dataset()
    session = _session(catalog, feedback=True)
    q = queries.build_query(10, catalog, optimized=False)
    session.execute(session.optimize(q))
    warm = optimize(q, catalog, config=session.optimizer_config())
    assert P.fingerprint(warm) == P.fingerprint(session.optimize(q))
    assert P.fingerprint(warm) != P.fingerprint(
        queries.build_query(10, catalog))
