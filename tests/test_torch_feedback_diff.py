"""The port's adaptive execution held against the reference's: Q3, Q5, Q10,
Q13 and Q18 at W = 1 run cold then warm on the reference's
``Session(catalog, feedback=True, kernel_backend="pallas")`` (kernels in
interpret mode) and on the port's ``Session(device="cpu", feedback=True)``
over the same tables, and Q3 at W = 2 as ``torch_diff.run_ref_dist`` runs
the reference. The plan nodes' ``feedback_key`` strings, the store entries
(``rows``, ``estimated``, ``max_matches``, ``skip_fraction``), the warm
plans' fingerprints and the warm footprint estimates must be equal, and
the warm results equal each other and the oracle. Each engine runs each
query once, in a module-scoped fixture."""

import pytest

pytest.importorskip("torch")

from torch_diff import DIST_SF, assert_same_result, port_catalog  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro.core import ICIExchange as RefICIExchange  # noqa: E402
from repro.core import optimizer as ref_optimizer  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch import ICIExchange  # noqa: E402
from repro_torch.core import optimizer as port_optimizer  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

SF = DIST_SF
QUERIES = [3, 5, 10, 13, 18]
W2_QUERY = 3
BATCH_ROWS = 8192


def _cold_warm(session, raw):
    cold_plan = session.optimize(raw)
    cold = session.execute(cold_plan)
    warm_plan = session.optimize(raw)
    warm = session.execute(warm_plan)
    return {"cold_plan": cold_plan, "warm_plan": warm_plan, "cold": cold,
            "warm": warm, "store": session.feedback_store()}


def _run(workers: int, qnums):
    data = ref_dbgen.generate(sf=SF)
    ref_cat = ref_dbgen.load_catalog(sf=SF)
    port_cat = port_catalog(data)
    runs = {}
    for q in qnums:
        ref_kw, port_kw = {}, {}
        if workers > 1:
            ref_kw = {"num_workers": workers, "exchange": RefICIExchange()}
            port_kw = {"num_workers": workers, "exchange": ICIExchange()}
        ref = RefSession(ref_cat, batch_rows=BATCH_ROWS, feedback=True,
                         kernel_backend="pallas", **ref_kw)
        port = Session(port_cat, batch_rows=BATCH_ROWS, device="cpu",
                       feedback=True, **port_kw)
        runs[q] = (
            _cold_warm(ref, ref_queries.build_query(q, ref_cat,
                                                    optimized=False)),
            _cold_warm(port, queries.build_query(q, port_cat,
                                                 optimized=False)),
            (ref_cat, port_cat))
    return data, runs


@pytest.fixture(scope="module")
def w1():
    return _run(1, QUERIES)


@pytest.fixture(scope="module")
def w2():
    return _run(2, [W2_QUERY])


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _entries(store):
    return {k: (e.rows, e.estimated, e.max_matches, e.skip_fraction)
            for k, e in store._entries.items()}


def _check_keys(ref, port):
    for which in ("cold_plan", "warm_plan"):
        rn, pn = list(_walk(ref[which])), list(_walk(port[which]))
        assert [type(n).__name__ for n in rn] == \
            [type(n).__name__ for n in pn]
        for a, b in zip(rn, pn):
            assert ref_plan.feedback_key(a) == port_plan.feedback_key(b)


def _check_store(ref, port, cats, workers):
    want = _entries(ref["store"])
    assert want, "the reference recorded nothing"
    assert _entries(port["store"]) == want
    # every observed plan node keys the same in both stores
    for rn, pn in zip(_walk(ref["cold_plan"]), _walk(port["cold_plan"])):
        assert ref["store"].key_for(rn, cats[0], workers) == \
            port["store"].key_for(pn, cats[1], workers)


@pytest.mark.parametrize("q", QUERIES)
def test_feedback_keys_equal_node_for_node(q, w1):
    ref, port, _ = w1[1][q]
    _check_keys(ref, port)


@pytest.mark.parametrize("q", QUERIES)
def test_store_entries_equal(q, w1):
    ref, port, cats = w1[1][q]
    _check_store(ref, port, cats, 1)


@pytest.mark.parametrize("q", QUERIES)
def test_warm_plan_fingerprint_equal(q, w1):
    ref, port, _ = w1[1][q]
    assert port_plan.fingerprint(port["cold_plan"]) == \
        ref_plan.fingerprint(ref["cold_plan"])
    assert port_plan.fingerprint(port["warm_plan"]) == \
        ref_plan.fingerprint(ref["warm_plan"])


@pytest.mark.parametrize("q", QUERIES)
def test_warm_memory_estimate_equal(q, w1):
    ref, port, cats = w1[1][q]
    want = ref_optimizer.estimate_memory_breakdown(
        ref["warm_plan"], cats[0], batch_rows=BATCH_ROWS,
        feedback=ref["store"])
    got = port_optimizer.estimate_memory_breakdown(
        port["warm_plan"], cats[1], batch_rows=BATCH_ROWS,
        feedback=port["store"])
    assert got.per_node == want.per_node


@pytest.mark.parametrize("q", QUERIES)
def test_warm_results_equal_each_other_and_oracle(q, w1):
    data, runs = w1
    ref, port, _ = runs[q]
    assert_same_result(port["warm"], ref["warm"], q)
    assert_results_match(port["warm"], port["cold"], q)
    assert_results_match(port["warm"], oracle.ORACLES[q](data), q)


def test_w2_matches_reference(w2):
    data, runs = w2
    ref, port, cats = runs[W2_QUERY]
    _check_keys(ref, port)
    _check_store(ref, port, cats, 2)
    assert port_plan.fingerprint(port["warm_plan"]) == \
        ref_plan.fingerprint(ref["warm_plan"])
    assert_same_result(port["warm"], ref["warm"], W2_QUERY)
    assert_results_match(port["warm"], oracle.ORACLES[W2_QUERY](data),
                         W2_QUERY)


def _build_rows(plan, P):
    out = []

    def visit(node):
        if isinstance(node, P.Join):
            out.append((list(node.build_keys), node.build_rows))
        for c in node.children():
            visit(c)

    visit(plan)
    return out


def test_shared_store_across_queries_matches_reference(w1):
    """One store across queries, as a session keeps it: Q7's scan of
    supplier counts the rows left after the probe fused into it, and Q8,
    which builds a table from the same scan, plans ``build_rows`` from
    that count, too small, so its build takes the sorted-key path (one
    ``fallback_probe``). The reference does the same; the port keeps it
    (ROADMAP Queue C)."""
    data, runs = w1
    ref_cat, port_cat = runs[QUERIES[0]][2]
    ref = RefSession(ref_cat, batch_rows=BATCH_ROWS, feedback=True,
                     kernel_backend="pallas")
    port = Session(port_cat, batch_rows=BATCH_ROWS, device="cpu",
                   feedback=True)
    for q in (7, 8):
        rp = ref.optimize(ref_queries.build_query(q, ref_cat,
                                                  optimized=False))
        pp = port.optimize(queries.build_query(q, port_cat,
                                               optimized=False))
        assert port_plan.fingerprint(pp) == ref_plan.fingerprint(rp)
        got, want = port.execute(pp), ref.execute(rp)
        assert port.executor_stats()["kernel_dispatch"] == \
            ref.executor_stats()["kernel_dispatch"]
        assert_same_result(got, want, q)
        assert_results_match(got, oracle.ORACLES[q](data), q)
    assert _build_rows(pp, port_plan)[0] == (["s_suppkey"], 1)
    assert port.executor_stats()["kernel_dispatch"]["fallback_probe"] == 1
    assert _entries(port.feedback_store()) == _entries(ref.feedback_store())
