"""The port's first slice end to end: TPC-H Q6 and Q1 through
``repro_torch``'s ``Session(device="cpu").execute`` at SF 0.01 with
8192-row morsels (8 morsels), held against the JAX engine under both kernel
backends, the numpy oracle, and the reference's kernel dispatch counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_diff import to_port  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro.core import plan as ref_plan  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.core.session import Catalog, Session  # noqa: E402
from repro_torch.tpch import dbgen, queries, schema  # noqa: E402

SF = 0.01
BATCH_ROWS = 8192
QUERIES = [6, 1]


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=SF)


@pytest.fixture(scope="module")
def ref_catalog():
    return ref_dbgen.load_catalog(sf=SF)


@pytest.fixture(scope="module")
def port_catalog(data):
    # the reference's generated bytes, so both engines scan the same data
    return Catalog.from_numpy(
        data, schema.SCHEMAS, {n: (k,) for n, k in schema.PRIMARY_KEYS.items()})


@pytest.fixture(scope="module")
def port_runs(port_catalog):
    runs = {}
    for q in QUERIES:
        session = Session(port_catalog, batch_rows=BATCH_ROWS, device="cpu")
        out = session.execute(queries.build_query(q, port_catalog))
        runs[q] = (out, session.executor_stats())
    return runs


@pytest.fixture(scope="module")
def ref_runs(ref_catalog):
    runs = {}
    for backend in ("pallas", "jnp"):
        for q in QUERIES:
            session = RefSession(ref_catalog, batch_rows=BATCH_ROWS,
                                 kernel_backend=backend)
            out = session.execute(ref_queries.build_query(q, ref_catalog))
            runs[backend, q] = (out, session.executor_stats())
    return runs


@pytest.mark.parametrize("sf,seed", [(0.01, 19940729), (0.003, 7)])
def test_dbgen_is_bit_identical(sf, seed):
    want = ref_dbgen.generate(sf, seed)
    got = dbgen.generate(sf, seed)
    assert list(got) == list(want)
    for table in want:
        assert list(got[table]) == list(want[table])
        for c, arr in want[table].items():
            assert got[table][c].dtype == arr.dtype, (table, c)
            np.testing.assert_array_equal(got[table][c], arr,
                                          err_msg=f"{table}.{c}")


def test_schemas_match_reference():
    from repro.tpch import schema as ref_schema
    for name, sch in ref_schema.SCHEMAS.items():
        assert schema.SCHEMAS[name] == to_port(sch)
    assert schema.PRIMARY_KEYS == ref_schema.PRIMARY_KEYS


@pytest.mark.parametrize("q", QUERIES)
def test_plan_fingerprint_matches_optimized_reference(q, ref_catalog,
                                                      port_catalog):
    ref = ref_queries.build_query(q, ref_catalog)
    port = queries.build_query(q, port_catalog)
    assert port_plan.fingerprint(port) == ref_plan.fingerprint(ref)
    assert port_plan.fingerprint(to_port(ref)) == port_plan.fingerprint(port)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax_engine(q, backend, port_runs, ref_runs):
    got, _ = port_runs[q]
    want, _ = ref_runs[backend, q]
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
    assert_results_match(got, want, q)


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_oracle(q, data, port_runs):
    got, _ = port_runs[q]
    assert_results_match(got, oracle.ORACLES[q](data), q)


@pytest.mark.parametrize("q", QUERIES)
def test_kernel_dispatch_matches_pallas_reference(q, port_runs, ref_runs):
    _, stats = port_runs[q]
    _, ref_stats = ref_runs["pallas", q]
    assert stats["kernel_dispatch"] == ref_stats["kernel_dispatch"]
    assert stats["kernel_dispatch"] == (
        {"fused": 8} if q == 6 else {"fused": 8, "agg": 15})
    assert stats["tables"]["lineitem"]["morsels"] == 8


def test_session_without_device_needs_a_gpu(port_catalog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Session() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(port_catalog)


def test_unported_nodes_and_workers_raise(port_catalog):
    session = Session(port_catalog, device="cpu")
    # a bare Repartition runs: at W=1 every row goes to the one worker, in
    # scan order, through one metadata phase
    scan = port_plan.TableScan("lineitem", ["l_orderkey", "l_quantity"])
    want = session.execute(scan)
    got = session.execute(port_plan.Repartition(scan, ["l_orderkey"]))
    assert sorted(got) == sorted(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    stats = session.executor_stats()
    assert stats["kernel_dispatch"] == {"partition": 1}
    assert list(stats["exchanges"]) == ["#0 Repartition(l_orderkey)"]
    # an InMemorySource scans its host arrays in morsels
    source = port_plan.InMemorySource("t", {"x": np.arange(3)},
                                      {"x": schema.LINEITEM["l_orderkey"]})
    got = session.execute(source)
    np.testing.assert_array_equal(got["x"], np.arange(3, dtype=np.int32))
    # two workers run Q6 planned for two workers, and match one worker
    two = Session(port_catalog, device="cpu", num_workers=2)
    q6 = two.execute(queries.build_query(6, port_catalog, num_workers=2))
    one = session.execute(queries.build_query(6, port_catalog))
    assert sorted(q6) == sorted(one) == ["revenue"]
    np.testing.assert_allclose(q6["revenue"], one["revenue"], rtol=1e-5)
    assert list(two.executor_stats()["exchanges"]) == ["#0 Broadcast"]


def _edge_tables(case):
    """SF 0.002, with lineitem emptied, or cut to rows that no filter
    keeps; ``ragged_morsels`` keeps it whole (its last morsel is short)."""
    data = ref_dbgen.generate(sf=0.002)
    li = data["lineitem"]
    if case == "empty":
        li = {c: v[:0] for c, v in li.items()}
    elif case == "all_filtered":
        li = {c: v[:700] for c, v in li.items()}
        li["l_shipdate"] = np.full(700, 20000, np.int32)   # after both ranges
    return dict(data, lineitem=li)


@pytest.mark.parametrize("case,batch_rows", [("empty", 256),
                                             ("all_filtered", 256),
                                             ("ragged_morsels", 3000)])
@pytest.mark.parametrize("q", QUERIES)
def test_edge_inputs_match_pallas_reference(q, case, batch_rows):
    from repro.core.session import Catalog as RefCatalog
    from repro.core.session import InMemoryTable as RefTable
    from repro.tpch import schema as ref_schema
    data = _edge_tables(case)
    ref_cat = RefCatalog()
    for name, cols in data.items():
        ref_cat.register(RefTable(name, cols, ref_schema.SCHEMAS[name],
                                  (ref_schema.PRIMARY_KEYS[name],)))
    ref = RefSession(ref_cat, batch_rows=batch_rows, kernel_backend="pallas")
    want = ref.execute(ref_queries.build_query(q, ref_cat))
    catalog = Catalog.from_numpy(data, schema.SCHEMAS)
    session = Session(catalog, batch_rows=batch_rows, device="cpu")
    got = session.execute(queries.build_query(q, catalog))
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].shape == want[c].shape, c
        np.testing.assert_allclose(got[c], want[c], rtol=1e-5, err_msg=c)
    assert (session.executor_stats()["kernel_dispatch"]
            == ref.executor_stats()["kernel_dispatch"])
