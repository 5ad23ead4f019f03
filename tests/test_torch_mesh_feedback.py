"""Adaptive execution on a mesh session (``Session(mesh=...,
feedback=True)``) against the reference's one-device mesh session
(``torch_diff.ref_mesh_session`` under its ``pallas`` backend, kernels in
interpret mode: the probes fuse into the scans there as in the port, so
the scans observe the same rows), on the CPU at SF 0.002 with 8192-row
morsels.

Q3 and Q18 at W = 2 and Q3, Q5 and Q18 at W = 4 run cold, then warm from
what the cold run observed, in each engine on a store of their own: the
plan nodes' ``feedback_key`` strings, the store entries (``rows``,
``estimated``, ``max_matches``, ``skip_fraction``; the driver counts each
worker's rows on its own device and sums them at the one read-back, and
gathers a join's build keys to worker 0's device for its multiplicity),
the cold and warm plans' fingerprints and the warm results must be equal,
and the warm results equal the oracle. A two-device mesh records the same
store, and the scheduler's q-error eviction goes miss, miss, hit on a mesh
as off it."""

import pytest

pytest.importorskip("torch")

from test_torch_feedback_diff import (_check_keys, _check_store,  # noqa: E402
                                      _cold_warm, _entries)
from torch_diff import (DIST_SF, assert_same_result,  # noqa: E402
                        port_catalog, port_mesh_session, ref_mesh_session)
from tpch_util import assert_results_match  # noqa: E402

from repro.core import plan as ref_plan  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch import SchedulerConfig  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

CASES = [(2, 3), (2, 18), (4, 3), (4, 5), (4, 18)]


def _id(case):
    return f"W{case[0]}-Q{case[1]}"


@pytest.fixture(scope="module")
def runs():
    data = ref_dbgen.generate(sf=DIST_SF)
    ref_cat = ref_dbgen.load_catalog(sf=DIST_SF)
    port_cat = port_catalog(data)
    out = {}
    for w, q in CASES:
        ref = ref_mesh_session(ref_cat, w, backend="pallas", feedback=True)
        port = port_mesh_session(port_cat, w, feedback=True)
        out[w, q] = (
            _cold_warm(ref, ref_queries.build_query(q, ref_cat,
                                                    optimized=False)),
            _cold_warm(port, queries.build_query(q, port_cat,
                                                 optimized=False)),
            (ref_cat, port_cat))
    return data, out


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_feedback_keys_equal_node_for_node(case, runs):
    ref, port, _ = runs[1][case]
    _check_keys(ref, port)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_store_entries_equal(case, runs):
    ref, port, cats = runs[1][case]
    _check_store(ref, port, cats, case[0])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plan_fingerprints_equal(case, runs):
    ref, port, _ = runs[1][case]
    for which in ("cold_plan", "warm_plan"):
        assert port_plan.fingerprint(port[which]) == \
            ref_plan.fingerprint(ref[which])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_warm_results_equal_each_other_and_oracle(case, runs):
    data, out = runs
    ref, port, _ = out[case]
    q = case[1]
    assert_same_result(port["warm"], ref["warm"], q)
    assert_results_match(port["warm"], port["cold"], q)
    assert_results_match(port["warm"], oracle.ORACLES[q](data), q)


@pytest.mark.parametrize("case", [(4, 5)], ids=_id)
def test_a_two_device_mesh_records_the_same_store(case, runs):
    _, port, cats = runs[1][case]
    w, q = case
    two = port_mesh_session(cats[1], w, devices=2, feedback=True)
    got = _cold_warm(two, queries.build_query(q, cats[1], optimized=False))
    assert _entries(got["store"]) == _entries(port["store"])
    assert port_plan.fingerprint(got["warm_plan"]) == \
        port_plan.fingerprint(port["warm_plan"])


def test_qerror_eviction_on_a_mesh(runs):
    data, out = runs
    cat = out[CASES[0]][2][1]
    session = port_mesh_session(cat, 4, feedback=True)
    session.scheduler_config = SchedulerConfig(cache_results=False)
    raw = queries.build_query(3, cat, optimized=False)
    try:
        handles = []
        for _ in range(3):
            handles.append(session.submit(raw))
            assert_results_match(handles[-1].result(timeout=60),
                                 oracle.ORACLES[3](data), 3)
    finally:
        session.scheduler().close()
    assert [h.plan_cache_hit for h in handles] == [False, False, True]
    assert all(h.executor_stats["worker_devices"] == ["cpu"] * 4
               for h in handles)
