"""Seeded SQL texts through both engines' ``Session.sql``: the fuzzer of
``tests/sql_oracle.py`` (``fuzz_queries``: scans, filters, groups and joins
over the TPC-H schema; ``fuzz_small_queries``: the serving corpus of point
lookups, filtered aggregates and small group-bys) at SF 0.002. Each text
runs on the reference and on the port's ``Session(device="cpu")``, and the
results must match under ``tpch_util.assert_results_match``; no DuckDB is
needed."""

import pytest

pytest.importorskip("torch")

from sql_oracle import fuzz_queries, fuzz_small_queries  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402
from torch_diff import port_catalog  # noqa: E402

from repro.core.session import Session as RefSession  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402

SF = 0.002
SEED = 7
N = 24


@pytest.fixture(scope="module")
def engines():
    data = ref_dbgen.generate(sf=SF)
    ref_catalog = ref_dbgen.load_catalog(sf=SF)
    texts = {"fuzz": fuzz_queries(SEED, N, ref_catalog),
             "small": fuzz_small_queries(SEED, N, ref_catalog)}
    return (texts, RefSession(ref_catalog, batch_rows=16384),
            Session(port_catalog(data), batch_rows=16384, device="cpu"))


@pytest.mark.parametrize("i", range(N))
@pytest.mark.parametrize("corpus", ["fuzz", "small"])
def test_fuzzed_text_matches_reference(corpus, i, engines):
    texts, ref, port = engines
    text = texts[corpus][i]
    want = ref.sql(text).collect()
    got = port.sql(text).collect()
    assert sorted(got) == sorted(want), text
    assert_results_match(got, want, f"{corpus}{i}: {text}")
