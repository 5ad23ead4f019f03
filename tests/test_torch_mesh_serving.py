"""Serving on a mesh session (``Session(mesh=...)`` with ``submit``,
``run`` and ``gather``) against the reference's one-device mesh session
(``torch_diff.ref_mesh_session``: ``make_engine_mesh(1)``,
``ICIExchange(mesh=...)``, its ``jnp`` backend) and the oracle, on the CPU
at SF 0.002 with 8192-row morsels.

* Q3, Q5 and Q13 at W = 4 through the scheduler of a mesh session, from
  concurrent submits, ``run`` and ``gather``: each result equals the
  reference's mesh ``execute`` and the oracle, with the same exchange
  counters.
* Batched serving at W = 1 on a one-device mesh: the distinct-literal
  workload of ``test_torch_serving.py`` forms stacked launches (no
  fallback) whose results equal serial execution off the mesh.
* A per-query worker count the mesh cannot split fails its handle with
  ``EngineMesh.check``'s ``ValueError``, batched or not, and runs nowhere
  else.
* ``Session.execute(plan, options=...)``, the reference's signature, with
  an ``ExecutionOptions(num_workers=...)`` override on a mesh session.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_serving import (_assert_columns_equal,  # noqa: E402
                                _submit_concurrently, _workload)
from test_torch_serving import dataset as serving_dataset  # noqa: E402
from torch_diff import (DIST_SF, exchange_counters,  # noqa: E402
                        port_catalog, port_mesh_session, ref_mesh_session,
                        run_ref_mesh)
from tpch_util import assert_results_match  # noqa: E402

from repro.core.session import ExecutionOptions as RefOptions  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch import ExecutionOptions, SchedulerConfig  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

QUERIES = (3, 5, 13)
W = 4


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=DIST_SF)


@pytest.fixture(scope="module")
def catalog(data):
    return port_catalog(data)


@pytest.fixture(scope="module")
def ref_runs():
    return run_ref_mesh(QUERIES, W)


def test_scheduled_queries_on_a_mesh_equal_reference_and_oracle(
        data, catalog, ref_runs):
    session = port_mesh_session(catalog, W)
    plans = {q: queries.build_query(q, catalog, num_workers=W)
             for q in QUERIES}
    try:
        handles = {q: session.submit(p) for q, p in plans.items()}
        got = dict(zip(QUERIES, session.gather(*handles.values())))
        got_run = session.run(plans[QUERIES[0]])
        stats = session.scheduler().stats()
    finally:
        session.scheduler().close()
    assert stats["failed"] == 0 and stats["completed"] == len(QUERIES) + 1
    for q in QUERIES:
        _, want, want_stats = ref_runs[q]
        assert_results_match(got[q], want, q)
        assert_results_match(got[q], oracle.ORACLES[q](data), q)
        es = handles[q].executor_stats
        assert es["worker_devices"] == ["cpu"] * W
        assert exchange_counters(es) == exchange_counters(want_stats)
    assert_results_match(got_run, ref_runs[QUERIES[0]][1], QUERIES[0])


def test_batched_serving_on_a_one_device_mesh_equals_solo():
    catalog = port_catalog(serving_dataset())
    builders = _workload(catalog, 24)
    serial = Session(catalog, device="cpu", batch_rows=16384)
    want = [serial.execute(b.optimized()) for b in builders]
    session = port_mesh_session(catalog, 1, batch_rows=16384)
    session.scheduler_config = SchedulerConfig(
        memory_budget=512 << 20, max_concurrency=4, max_queue=256,
        cache_results=False, batching=True, batch_window_ms=150.0,
        max_batch=32)
    try:
        handles = _submit_concurrently(session, builders)
        stats = session.scheduler().stats()
    finally:
        session.scheduler().close()
    assert stats["batches"] >= 1 and stats["batch_fallbacks"] == 0
    for i, h in enumerate(handles):
        _assert_columns_equal(want[i], h.result(), f"q{i}")
        assert h.executor_stats["worker_devices"] == ["cpu"]
    batched = [h for h in handles if "batch" in h.executor_stats]
    assert len(batched) == stats["batched_queries"] >= 2


@pytest.mark.parametrize("batching", [False, True])
def test_a_worker_count_the_mesh_cannot_split_fails_its_handle(
        catalog, batching):
    session = port_mesh_session(catalog, W, devices=2)
    session.scheduler_config = SchedulerConfig(batching=batching,
                                               cache_results=False)
    plan = queries.build_query(6, catalog)
    try:
        bad = [session.submit(plan, options=ExecutionOptions(num_workers=n))
               for n in (1, 3)]
        good = session.submit(queries.build_query(6, catalog, num_workers=2),
                              options=ExecutionOptions(num_workers=2))
        for h in bad:
            with pytest.raises(ValueError, match="do not split evenly"):
                h.result(timeout=60)
            assert h.executor_stats["worker_devices"] == []   # never ran
        got = good.result(timeout=60)
        stats = session.scheduler().stats()
    finally:
        session.scheduler().close()
    assert stats["failed"] == 2 and stats["batch_fallbacks"] == 0
    assert good.executor_stats["worker_devices"] == ["cpu"] * 2
    want = Session(catalog, device="cpu", batch_rows=8192).execute(
        queries.build_query(6, catalog))
    assert_results_match(got, want, 6)


def test_execute_takes_options_as_the_reference(data, catalog):
    ref_cat = ref_dbgen.load_catalog(sf=DIST_SF)
    ref = ref_mesh_session(ref_cat, W)
    port = port_mesh_session(catalog, W)
    for w in (W, 2):
        opts = (None, None) if w == W else (
            RefOptions(num_workers=w), ExecutionOptions(num_workers=w))
        want = ref.execute(ref_queries.build_query(5, ref_cat,
                                                   num_workers=w),
                           options=opts[0])
        got = port.execute(queries.build_query(5, catalog, num_workers=w),
                           options=opts[1])
        assert_results_match(got, want, 5)
        assert_results_match(got, oracle.ORACLES[5](data), 5)
        assert port.executor_stats()["worker_devices"] == ["cpu"] * w
        assert (exchange_counters(port.executor_stats())
                == exchange_counters(ref.executor_stats()))
    with pytest.raises(ValueError, match="do not split evenly"):
        port_mesh_session(catalog, W, devices=2).execute(
            queries.build_query(5, catalog, num_workers=3),
            options=ExecutionOptions(num_workers=3))
