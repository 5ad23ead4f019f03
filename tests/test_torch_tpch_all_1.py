"""All 22 TPC-H queries through the port, part 1 of 3 (Q1-Q8), at SF
0.005 with 8192-row morsels: the port's own ``build_query`` plan must
fingerprint equal to the reference's, and its run on
``Session(device="cpu")`` must match the numpy oracle and the reference's
``pallas`` run, with the same ``kernel_dispatch`` kinds and counts.
Every call of the fused morsel program is lowered as the card lowers it
and run through the emulator against the plain version. Each engine runs
each query once, in module-scoped fixtures."""

import pytest

pytest.importorskip("torch")

from torch_diff import (TPCH_SF, assert_same_result,  # noqa: E402
                        emulate_fused_call, run_port_queries,
                        run_ref_queries, to_port)
from tpch_util import assert_results_match  # noqa: E402

from repro.core import plan as ref_plan  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402

QUERIES = [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=TPCH_SF)


@pytest.fixture(scope="module")
def ref_runs():
    return run_ref_queries(QUERIES)


@pytest.fixture(scope="module")
def port_runs(data):
    return run_port_queries(QUERIES, data)


@pytest.mark.parametrize("q", QUERIES)
def test_plan_fingerprint_matches_reference(q, port_runs, ref_runs):
    port, ref = port_runs[q][0], ref_runs[q][0]
    assert port_plan.fingerprint(port) == ref_plan.fingerprint(ref)
    assert port_plan.fingerprint(to_port(ref)) == port_plan.fingerprint(port)


@pytest.mark.parametrize("q", QUERIES)
def test_result_matches_oracle(q, data, port_runs):
    assert_results_match(port_runs[q][1], oracle.ORACLES[q](data), q)


@pytest.mark.parametrize("q", QUERIES)
def test_result_matches_pallas_reference(q, port_runs, ref_runs):
    assert_same_result(port_runs[q][1], ref_runs[q][1], q)


@pytest.mark.parametrize("q", QUERIES)
def test_kernel_dispatch_matches_pallas_reference(q, port_runs, ref_runs):
    assert (port_runs[q][2]["kernel_dispatch"]
            == ref_runs[q][2]["kernel_dispatch"])


@pytest.mark.parametrize("q", QUERIES)
def test_fused_programs_emulate_plain(q, port_runs):
    for table, stages, probe in port_runs[q][3]:
        emulate_fused_call(table, stages, probe)
