"""The 22 TPC-H queries cold then warm on the port (the counterpart of the
reference's ``-m adaptive`` sweep, run here unmarked): one feedback store
per session, W = 1 and W = 2 (``ICIExchange``), at SF 0.002 on the CPU,
each run against the reference's oracle. Adaptivity may change capacities,
distributions and join orientation, never answers.

Also the recorded deviation from the reference's
``test_warm_runs_reduce_pallas_fallbacks``: that test needs queries that
fall back cold at SF 0.02, which the reference's TPU hash-table limit
(``MAX_HASH_TABLE_SLOTS = 1 << 18``) forces and the port's (``1 << 25``)
does not. What still holds is checked: warm never raises a
``fallback_probe`` count, and never raises a capacity above the cold
plan's."""

import functools

import pytest

pytest.importorskip("torch")

from torch_diff import port_catalog  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro_torch import ICIExchange  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

SF = 0.002
FALLBACK_SF = 0.02
QUERIES = sorted(queries.QUERIES)


@functools.lru_cache(maxsize=2)
def dataset(sf: float):
    data = ref_dbgen.generate(sf=sf)
    return data, port_catalog(data)


@functools.lru_cache(maxsize=None)
def expected(q: int):
    return oracle.ORACLES[q](dataset(SF)[0])


def _session(catalog, workers: int) -> Session:
    kw = {"num_workers": workers, "exchange": ICIExchange()} \
        if workers > 1 else {}
    return Session(catalog, device="cpu", feedback=True, **kw)


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("q", QUERIES)
def test_cold_then_warm_matches_oracle(q, workers):
    _, catalog = dataset(SF)
    session = _session(catalog, workers)
    raw = queries.build_query(q, catalog, optimized=False)
    cold_plan = session.optimize(raw)
    assert P.fingerprint(cold_plan) == P.fingerprint(
        queries.build_query(q, catalog, num_workers=workers))
    cold = session.execute(cold_plan)
    assert len(session.feedback_store()) > 0
    warm = session.execute(session.optimize(raw))
    assert_results_match(cold, expected(q), q)
    assert_results_match(warm, expected(q), q)
    assert_results_match(warm, cold, q)


_CAPACITIES = {"Aggregation": ("max_groups",), "Distinct": ("max_groups",),
               "Join": ("build_rows", "max_matches")}


def _capacities(plan):
    """feedback_key -> (field, value) for every sized node of a plan."""
    out = {}

    def visit(node):
        for f in _CAPACITIES.get(type(node).__name__, ()):
            out[(P.feedback_key(node), f)] = getattr(node, f)
        for c in node.children():
            visit(c)

    visit(plan)
    return out


def test_warm_never_raises_fallbacks_or_capacities():
    _, catalog = dataset(FALLBACK_SF)
    cold_fallbacks = {}
    for q in QUERIES:
        # a store of its own: another query's observations of a shared
        # subtree would make this query's first plan warm already
        session = _session(catalog, 1)
        raw = queries.build_query(q, catalog, optimized=False)
        cold_plan = session.optimize(raw)
        cold_out = session.execute(cold_plan)
        cold = session.executor_stats()["kernel_dispatch"].get(
            "fallback_probe", 0)
        warm_plan = session.optimize(raw)
        warm_out = session.execute(warm_plan)
        warm = session.executor_stats()["kernel_dispatch"].get(
            "fallback_probe", 0)
        assert warm <= cold, (q, cold, warm)
        static = _capacities(cold_plan)
        for key, value in _capacities(warm_plan).items():
            if key in static and static[key] is not None:
                assert value <= static[key], (q, key[1], value, static[key])
        assert_results_match(warm_out, cold_out, q)
        cold_fallbacks[q] = cold
    # the port's slot limit leaves no query falling back at this scale: the
    # reference's contract (>= 3 queries whose fallbacks warm runs reduce)
    # cannot be exercised and is recorded as a deviation (ROADMAP Queue C)
    assert sum(cold_fallbacks.values()) == 0, cold_fallbacks
