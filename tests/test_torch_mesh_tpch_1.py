"""TPC-H at W = 4 workers on a mesh through the port, part 1 of 2
(Q1-Q13), at SF 0.002 with 8192-row morsels, against the reference's
on-mesh run.

The port runs ``Session(device="cpu", num_workers=4,
mesh=EngineMesh([cpu]))``, whose ``ICIExchange(mesh=...)`` takes the
staged path (send-buffer layout, the all-to-all, receive-side
compaction); the reference runs the same plan on its one-device mesh
(``make_engine_mesh(1)``). Each result must match the reference's and the
numpy oracle, with the same exchange fragments (labels, rounds, rows and
bytes moved), no byte through the host and one ``partition`` dispatch per
repartition; and it must equal the port's own off-mesh W = 4 result. Each
engine runs each query once, in module-scoped fixtures."""

import pytest

pytest.importorskip("torch")

from torch_diff import (DIST_SF, assert_same_result,  # noqa: E402
                        exchange_counters, run_port_dist, run_port_mesh,
                        run_ref_mesh)
from tpch_util import assert_results_match  # noqa: E402

from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402

QUERIES = list(range(1, 14))


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=DIST_SF)


@pytest.fixture(scope="module")
def ref_mesh():
    return run_ref_mesh(QUERIES, 4)


@pytest.fixture(scope="module")
def port_mesh(data):
    return run_port_mesh(QUERIES, data, 4)


@pytest.fixture(scope="module")
def port_off_mesh(data):
    return run_port_dist(QUERIES, data, 4)


@pytest.mark.parametrize("q", QUERIES)
def test_mesh_w4_matches_reference_and_oracle(q, data, port_mesh, ref_mesh):
    got = port_mesh[q][1]
    assert_same_result(got, ref_mesh[q][1], q)
    assert_results_match(got, oracle.ORACLES[q](data), q)


@pytest.mark.parametrize("q", QUERIES)
def test_mesh_w4_exchanges_match_reference(q, port_mesh, ref_mesh):
    stats, ref_stats = port_mesh[q][2], ref_mesh[q][2]
    assert stats["exchange_protocol"] == "ici"
    assert stats["worker_devices"] == ["cpu"] * 4
    counters = exchange_counters(stats)
    assert counters == exchange_counters(ref_stats)
    assert all(c["host_staged_bytes"] == 0 for c in counters.values())
    repartitions = sum(c["rounds"] for k, c in counters.items() if "(" in k)
    assert stats["kernel_dispatch"].get("partition", 0) == repartitions


@pytest.mark.parametrize("q", QUERIES)
def test_mesh_w4_equals_off_mesh(q, port_mesh, port_off_mesh):
    assert_same_result(port_mesh[q][1], port_off_mesh[q][1], q)
    assert exchange_counters(port_mesh[q][2]) == exchange_counters(
        port_off_mesh[q][2])
