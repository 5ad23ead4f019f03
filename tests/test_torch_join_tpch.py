"""The port's join slice end to end: TPC-H Q3 and Q10 through
``repro_torch``'s ``Session(device="cpu").execute`` at SF 0.01 with
8192-row morsels, held against the JAX engine under both kernel backends,
the numpy oracle, and the reference's kernel dispatch counts. Each engine
runs each query once, in module-scoped fixtures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpch_util import assert_results_match  # noqa: E402

from repro.core import plan as ref_plan  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.core.session import Catalog, Session  # noqa: E402
from repro_torch.tpch import queries, schema  # noqa: E402

SF = 0.01
BATCH_ROWS = 8192
QUERIES = [3, 10]
# the reference's pallas run at SF 0.01, 8192-row morsels
DISPATCH = {3: {"build": 2, "fused": 10, "agg": 15},
            10: {"build": 3, "fused": 8, "agg": 15, "probe": 2}}


def _port_catalog(data):
    # the reference's generated bytes, so both engines scan the same data
    return Catalog.from_numpy(
        data, schema.SCHEMAS, {n: (k,) for n, k in schema.PRIMARY_KEYS.items()})


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=SF)


@pytest.fixture(scope="module")
def port_runs(data):
    catalog = _port_catalog(data)
    runs = {}
    for q in QUERIES:
        session = Session(catalog, batch_rows=BATCH_ROWS, device="cpu")
        out = session.execute(queries.build_query(q, catalog))
        runs[q] = (out, session.executor_stats())
    return runs


@pytest.fixture(scope="module")
def ref_runs():
    catalog = ref_dbgen.load_catalog(sf=SF)
    runs = {}
    for backend in ("pallas", "jnp"):
        for q in QUERIES:
            session = RefSession(catalog, batch_rows=BATCH_ROWS,
                                 kernel_backend=backend)
            out = session.execute(ref_queries.build_query(q, catalog))
            runs[backend, q] = (out, session.executor_stats())
    return runs


@pytest.mark.parametrize("sf", [SF, 0.003])
@pytest.mark.parametrize("q", QUERIES)
def test_plan_fingerprint_matches_optimized_reference(q, sf):
    ref_catalog = ref_dbgen.load_catalog(sf=sf)
    catalog = _port_catalog(ref_dbgen.generate(sf=sf))
    ref = ref_queries.build_query(q, ref_catalog)
    assert (port_plan.fingerprint(queries.build_query(q, catalog))
            == ref_plan.fingerprint(ref))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax_engine(q, backend, port_runs, ref_runs):
    got, _ = port_runs[q]
    want, _ = ref_runs[backend, q]
    # the reference's pytree flattening sorts columns by name
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        assert got[c].shape == want[c].shape, c
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
    assert stats["kernel_dispatch"] == DISPATCH[q]
    assert stats["tables"]["lineitem"]["morsels"] == 8


def test_top_rows_are_in_order(port_runs):
    q3, _ = port_runs[3]
    assert len(q3["revenue"]) == 10
    assert np.all(np.diff(q3["revenue"]) <= 0)
    q10, _ = port_runs[10]
    assert len(q10["revenue"]) == 20
    assert np.all(np.diff(q10["revenue"]) <= 0)
    assert q10["c_name"].shape == (20, 18) and q10["c_name"].dtype == np.uint8
