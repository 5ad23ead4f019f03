"""TPC-H at W workers on one device through the port, part 2 of 2
(Q12-Q22), at SF 0.002 with 8192-row morsels, against the reference.

For each query the port's ``build_query(q, catalog, num_workers=W)`` plan
must fingerprint equal to the reference's at W = 2 and 4; its W = 4 run
with ``ICIExchange`` must match the reference's W = 4 ICI run and the
numpy oracle, with the same exchange fragments (labels, rounds, rows and
bytes moved) and one ``partition`` dispatch per repartition, as many as
the reference's pallas run for Q13; its W = 2 and W = 4 results must
equal its own W = 1 result. The sample of the reference's distributed
oracle slice also runs at W = 2 through ``HostExchange``, against the
reference's host-staged run and the oracle. Each engine runs each
configuration once, in module-scoped fixtures."""

import pytest

pytest.importorskip("torch")

from torch_diff import (DIST_SF, HOST_SAMPLE, assert_same_result,  # noqa: E402
                        exchange_counters, port_catalog, run_port_dist,
                        run_ref_dist)
from tpch_util import assert_results_match  # noqa: E402

from repro.core import plan as ref_plan  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

QUERIES = list(range(12, 23))
PALLAS = (13,)
HOST = [q for q in HOST_SAMPLE if q in QUERIES]


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=DIST_SF)


@pytest.fixture(scope="module")
def ref_ici():
    return run_ref_dist(QUERIES, 4, "ici", pallas=PALLAS)


@pytest.fixture(scope="module")
def port_ici(data):
    return run_port_dist(QUERIES, data, 4, "ici")


@pytest.fixture(scope="module")
def ref_host():
    return run_ref_dist(HOST, 2, "host")


@pytest.fixture(scope="module")
def port_host(data):
    return run_port_dist(HOST, data, 2, "host")


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("q", QUERIES)
def test_plan_fingerprint_matches_reference(q, w, data):
    port = queries.build_query(q, port_catalog(data), num_workers=w)
    ref = ref_queries.build_query(q, ref_dbgen.load_catalog(sf=DIST_SF),
                                  num_workers=w)
    assert port_plan.fingerprint(port) == ref_plan.fingerprint(ref)


@pytest.mark.parametrize("q", QUERIES)
def test_ici_w4_matches_reference_and_oracle(q, data, port_ici, ref_ici):
    got = port_ici[q][1]
    assert_same_result(got, ref_ici[q][1], q)
    assert_results_match(got, oracle.ORACLES[q](data), q)


@pytest.mark.parametrize("q", QUERIES)
def test_ici_w4_exchanges_match_reference(q, port_ici, ref_ici):
    stats, ref_stats = port_ici[q][2], ref_ici[q][2]
    assert stats["exchange_protocol"] == "ici"
    assert exchange_counters(stats) == exchange_counters(ref_stats)
    # a repartition's label names its keys, a broadcast's does not
    rounds = sum(v["rounds"] for k, v in stats["exchanges"].items()
                 if "(" in k)
    assert stats["kernel_dispatch"].get("partition", 0) == rounds
    assert all(v["host_staged_bytes"] == 0
               for v in stats["exchanges"].values())


@pytest.mark.parametrize("q", PALLAS)
def test_partition_dispatch_matches_pallas_reference(q, port_ici, ref_ici):
    assert ref_ici[q][2]["kernel_backend"] == "pallas"
    assert (port_ici[q][2]["kernel_dispatch"]["partition"]
            == ref_ici[q][2]["kernel_dispatch"]["partition"])


@pytest.mark.parametrize("q", QUERIES)
def test_w2_and_w4_match_port_w1(q, data, port_ici):
    base = run_port_dist([q], data, 1)[q][1]
    assert_same_result(port_ici[q][1], base, q)
    assert_same_result(run_port_dist([q], data, 2)[q][1], base, q)


@pytest.mark.parametrize("q", HOST)
def test_host_w2_matches_reference_and_oracle(q, data, port_host, ref_host):
    got, stats = port_host[q][1], port_host[q][2]
    assert_same_result(got, ref_host[q][1], q)
    assert_results_match(got, oracle.ORACLES[q](data), q)
    assert stats["exchange_protocol"] == "host"
    assert exchange_counters(stats) == exchange_counters(ref_host[q][2])
    assert sum(v["host_staged_bytes"] for v in stats["exchanges"].values()) > 0
    assert "partition" not in stats["kernel_dispatch"]
