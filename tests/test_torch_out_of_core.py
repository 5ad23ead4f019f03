"""Out-of-core execution on the port (``Session(device_budget=...)``),
held against the reference and ``tpch.oracle`` on the CPU at SF 0.002.

* The reference's forced-spill differentials on the port: the six fast
  queries (1, 3, 6, 13, 14, 18) under a 16 KiB device budget, Q3 with the
  host tier squeezed so victims cascade to paged disk files (512 B device,
  4096 B host), Q3 at W = 4, and a scan sharing the spill manager's host
  budget; each equal to the oracle.
* The W = 1 spill counters (``executor_stats()["spill"]``) of Q3, Q13 and
  Q18 under 16 KiB, field for field the reference's under its ``pallas``
  backend (the path the port takes), and of the disk-tier Q3, the
  reference's under ``jnp``.
* ``GraceHashJoin`` against the reference's on seeded tables (inner, semi,
  anti and left-outer; ``max_matches`` 1 and 3; a composite key too wide
  to pack into 32 bits, which both hash), a worker-stacked grace join (two
  workers, one histogram over the ``W * P`` bins), an all-empty probe, and
  ``HashAggregation``'s flush mode against the reference's: the same rows
  and the same spill counters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import port_catalog, port_schema  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import operators as ref_ops  # noqa: E402
from repro.core import spill as ref_spill  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ops as ref_kernel_ops  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch import ICIExchange  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.spill import SpillManager  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

SF = 0.002
_FAST_QUERIES = [1, 3, 6, 13, 14, 18]
_BUDGET = 16 * 1024
# (query, device_budget, host_budget, the reference's backend) of each
# counter comparison; the disk-tier run is held to the reference's jnp
# backend, as its pallas run (interpret mode) takes over half a minute
_COUNTER_CASES = {"Q3": (3, _BUDGET, 1 << 31, "pallas"),
                  "Q13": (13, _BUDGET, 1 << 31, "pallas"),
                  "Q18": (18, _BUDGET, 1 << 31, "pallas"),
                  "Q3 disk": (3, 512, 4096, "jnp")}


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=SF)


@pytest.fixture(scope="module")
def catalog(data):
    return port_catalog(data)


def _run(catalog, q, w=1, **kw):
    session = Session(catalog, device="cpu", num_workers=w, **kw)
    out = session.execute(queries.build_query(q, catalog, num_workers=w))
    return out, session


# ---------------------------------------------------------------------------
# forced-spill differentials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qnum", _FAST_QUERIES)
def test_tiny_budget_oracle_identical(qnum, data, catalog):
    res, session = _run(catalog, qnum, batch_rows=4096,
                        device_budget=_BUDGET)
    assert_results_match(res, oracle.ORACLES[qnum](data), qnum)
    spill = session.executor_stats()["spill"]
    if qnum in (3, 13, 18):       # joins/high-cardinality aggs must spill
        assert spill["spilled_bytes"] > 0, spill


def test_tiny_budget_disk_tier_exercised(data, catalog):
    res, session = _run(catalog, 3, batch_rows=4096, device_budget=512,
                        host_budget=4096)
    assert_results_match(res, oracle.ORACLES[3](data), 3)
    spill = session.executor_stats()["spill"]
    assert spill["disk"]["spills"] > 0 and spill["disk"]["restores"] > 0
    # partitions proven unmatchable are dropped, not restored
    assert spill["disk"]["restored_bytes"] <= spill["disk"]["spilled_bytes"]


def test_tiny_budget_distributed(data, catalog):
    res, session = _run(catalog, 3, w=4, exchange=ICIExchange(),
                        batch_rows=2048, device_budget=_BUDGET)
    assert_results_match(res, oracle.ORACLES[3](data), 3)
    stats = session.executor_stats()
    assert stats["spill"]["spilled_bytes"] > 0
    assert stats["spill_staged_exchanges"] > 0


def test_scan_shares_spill_host_budget(data, catalog):
    # each morsel step proceeds only through the empty-budget progress
    # guarantee, and every byte comes back
    res, session = _run(catalog, 6, batch_rows=2048, device_budget=1 << 20,
                        host_budget=1)
    assert_results_match(res, oracle.ORACLES[6](data), 6)
    assert session.last_driver.ctx.spill.host.in_use == 0
    assert session.executor_stats()["tables"]["lineitem"]["morsels"] > 1


def test_no_budget_runs_in_memory(catalog):
    _, session = _run(catalog, 3, batch_rows=4096)
    stats = session.executor_stats()
    assert stats["spill"] == {} and stats["spill_staged_exchanges"] == 0
    assert session.last_driver.ctx.spill is None


def test_explain_analyze_prints_the_spill_tiers(catalog):
    session = Session(catalog, device="cpu", batch_rows=4096,
                      device_budget=_BUDGET)
    text = session.explain(queries.build_query(3, catalog), analyze=True)
    assert f"spill cost @ budget {_BUDGET} B" in text
    assert "spill: reserved_peak=" in text
    assert "spill host tier: spilled_bytes=" in text
    assert "spill disk tier: spilled_bytes=0" in text


# ---------------------------------------------------------------------------
# the spill counters equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(_COUNTER_CASES))
def test_spill_counters_equal_reference(case, catalog):
    q, device_budget, host_budget, backend = _COUNTER_CASES[case]
    ref_catalog = ref_dbgen.load_catalog(sf=SF)
    ref = RefSession(ref_catalog, num_workers=1, batch_rows=4096,
                     device_budget=device_budget, host_budget=host_budget,
                     kernel_backend=backend)
    ref.execute(ref_queries.build_query(q, ref_catalog))
    _, session = _run(catalog, q, batch_rows=4096,
                      device_budget=device_budget, host_budget=host_budget)
    want = ref.executor_stats()["spill"]
    got = session.executor_stats()["spill"]
    assert got == want
    assert got["spilled_bytes"] > 0


# ---------------------------------------------------------------------------
# GraceHashJoin and the flushing aggregation against the reference's
# ---------------------------------------------------------------------------

_SCHEMA = {"k": rdt.INT32, "w": rdt.INT32, "bi": rdt.INT32,
           "bf": rdt.FLOAT32, "pi": rdt.INT32}


def _sides(dup: bool, seed: int):
    """(build, build validity, probe, probe validity): ``dup`` puts up to
    three build rows on a key; a quarter of the probe rows miss; ``w`` is
    a full-range int32 column, so (k, w) does not pack into 32 bits."""
    rng = np.random.default_rng(seed)
    nk = 400
    k = rng.permutation(50_000)[:nk].astype(np.int32) - 10_000
    w = rng.integers(-2 ** 31, 2 ** 31 - 1, nk, dtype=np.int64).astype(
        np.int32)
    rows = (np.repeat(np.arange(nk), rng.integers(1, 4, nk)) if dup
            else np.arange(nk))
    rng.shuffle(rows)
    nb = len(rows)
    build = {"k": k[rows], "w": w[rows],
             "bi": rng.integers(-50, 50, nb).astype(np.int32),
             "bf": rng.normal(size=nb).astype(np.float32)}
    prow = rng.integers(0, nk, 1200)
    probe = {"k": k[prow], "w": w[prow],
             "pi": rng.integers(0, 9, 1200).astype(np.int32)}
    miss = rng.random(1200) < 0.25
    probe["k"][miss] = rng.integers(60_000, 70_000, int(miss.sum()))
    return build, rng.random(nb) < 0.9, probe, rng.random(1200) < 0.9


def _both(data, valid, capacity):
    schema = {c: _SCHEMA[c] for c in data}
    pad = np.pad(valid, (0, capacity - len(valid)))
    ref = DeviceTable.from_numpy(data, schema, capacity=capacity)
    ref = ref.filter(jnp.asarray(pad))
    port = TorchTable.from_numpy(data, port_schema(schema),
                                 capacity=capacity, device="cpu")
    return ref, port.filter(torch.from_numpy(pad))


def _rows(tables, names):
    """The live rows of ``tables`` as a sorted list of tuples."""
    out = []
    for t in tables:
        live = np.asarray(t.validity).reshape(-1).astype(bool)
        cols = [np.asarray(t.columns[n]).reshape(-1)[live] for n in names]
        out += list(zip(*(c.tolist() for c in cols)))
    return sorted(out)


def _column_names(t):
    return sorted(t.columns)


def _grace_pair(keys, payload, join_type, m, reservation, nbuild):
    ref_mgr = ref_spill.SpillManager(0)
    port_mgr = SpillManager(0, device="cpu")
    want = ref_ops.GraceHashJoin(keys, keys, payload, join_type, m,
                                 build_rows=nbuild, spill=ref_mgr,
                                 reservation=reservation)
    got = ops.GraceHashJoin(keys, keys, payload, join_type, m,
                            build_rows=nbuild, spill=port_mgr,
                            reservation=reservation)
    return want, got, ref_mgr, port_mgr


def _drive(op, build, probes):
    op.open()
    op.add_build(build)
    op.seal_build()
    outs = []
    for p in probes:
        outs += op.add_input(p)
    return outs + op.finish()


@pytest.mark.parametrize("composite", [False, True])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("join_type", ["inner", "left_semi", "left_anti",
                                       "left_outer"])
def test_grace_hash_join_matches_reference(join_type, m, composite):
    keys = ("k", "w") if composite else ("k",)
    build, bvalid, probe, pvalid = _sides(dup=m > 1, seed=m + 2 * composite)
    payload = () if join_type in ("left_semi", "left_anti") else ("bi", "bf")
    rb, pb = _both(build, bvalid, 2048)
    probes = [_both({c: v[lo:lo + 600] for c, v in probe.items()},
                    pvalid[lo:lo + 600], 1024) for lo in (0, 600)]
    # a quarter of the build side's bytes: four partitions, about one of
    # them resident
    reservation = rb.nbytes() // 2
    want_op, got_op, ref_mgr, port_mgr = _grace_pair(
        keys, payload, join_type, m, reservation, len(build["k"]))
    with ref_kernel_ops.use_backend("jnp"):
        want = _drive(want_op, rb, [r for r, _ in probes])
    counts = {}
    with kernel_ops.collect_dispatches(counts):
        got = [s[0] for s in _drive(got_op, [pb], [[p] for _, p in probes])]
    assert got_op.num_partitions == want_op.num_partitions == 4
    assert _column_names(got[0]) == _column_names(want[0])
    names = _column_names(want[0])
    assert _rows(got, names) == _rows(want, names)
    assert port_mgr.stats.summary() == ref_mgr.stats.summary()
    assert port_mgr.stats.host.spills > 0
    # one histogram a _grace_pids call: the build side and each probe batch
    assert counts["partition"] == 3
    # odd partitions are empty (the reference's placement)
    assert not any(got_op._build_rows_by_part[p] for p in (1, 3))


def test_grace_hash_join_stacked_workers_match_reference():
    w = 2
    build, bvalid, probe, pvalid = _sides(dup=True, seed=9)
    halves = []
    for i in range(w):
        sl = slice(i * 300, (i + 1) * 300)
        halves.append(_both({c: v[sl] for c, v in build.items()},
                            bvalid[sl], 512))
    rb = DeviceTable({n: jnp.stack([h[0].columns[n] for h in halves])
                      for n in build}, jnp.stack([h[0].validity
                                                  for h in halves]),
                     dict(halves[0][0].schema))
    pb = [h[1] for h in halves]
    rp_parts = [_both({c: v[i * 600:(i + 1) * 600] for c, v in probe.items()},
                      pvalid[i * 600:(i + 1) * 600], 1024) for i in range(w)]
    rp = DeviceTable({n: jnp.stack([h[0].columns[n] for h in rp_parts])
                      for n in probe}, jnp.stack([h[0].validity
                                                  for h in rp_parts]),
                     dict(rp_parts[0][0].schema))
    pp = [h[1] for h in rp_parts]
    reservation = rb.nbytes() // 4
    want_op, got_op, ref_mgr, port_mgr = _grace_pair(
        ("k",), ("bi", "bf"), "inner", 3, reservation, 600)
    with ref_kernel_ops.use_backend("jnp"):
        want = _drive(want_op, rb, [rp])
    got = _drive(got_op, pb, [pp])
    assert got_op.num_partitions == want_op.num_partitions == 8
    assert all(len(step) == w for step in got)
    names = _column_names(want[0])
    for i in range(w):
        got_i = [step[i] for step in got]
        want_i = [DeviceTable({n: a[i] for n, a in t.columns.items()},
                              t.validity[i], t.schema) for t in want]
        assert _rows(got_i, names) == _rows(want_i, names)
    assert port_mgr.stats.summary() == ref_mgr.stats.summary()


def test_grace_hash_join_all_probe_rows_dead_emits_one_empty_batch():
    build, bvalid, probe, _ = _sides(dup=False, seed=4)
    rb, pb = _both(build, bvalid, 1024)
    rp, pp = _both(probe, np.zeros(1200, dtype=bool), 2048)
    want_op, got_op, _, _ = _grace_pair(("k",), ("bi",), "inner", 1,
                                        rb.nbytes() // 2, 400)
    with ref_kernel_ops.use_backend("jnp"):
        want = _drive(want_op, rb, [rp])
    got = [s[0] for s in _drive(got_op, [pb], [[pp]])]
    assert len(got) == len(want) == 1
    assert _column_names(got[0]) == _column_names(want[0])
    assert not bool(got[0].validity.any())


_AGGS = (("s", "sum", "v"), ("n", "count", None), ("lo", "min", "v"),
         ("hi", "max", "i"), ("a", "avg", "v"))


def test_flushing_aggregation_matches_reference():
    rng = np.random.default_rng(5)
    schema = {"g": rdt.INT32, "v": rdt.FLOAT32, "i": rdt.INT32}
    batches = []
    for b in range(5):
        n = 700
        data = {"g": rng.integers(0, 90, n).astype(np.int32),
                "v": rng.normal(size=n).astype(np.float32),
                "i": rng.integers(-1000, 1000, n).astype(np.int32)}
        valid = rng.random(n) < 0.85
        pad = np.pad(valid, (0, 1024 - n))
        ref = DeviceTable.from_numpy(data, schema, capacity=1024).filter(
            jnp.asarray(pad))
        port = TorchTable.from_numpy(data, port_schema(schema), capacity=1024,
                                     device="cpu").filter(
            torch.from_numpy(pad))
        batches.append((ref, port))
    ref_mgr = ref_spill.SpillManager(0)
    port_mgr = SpillManager(0, device="cpu")
    want_op = ref_ops.HashAggregation(("g",), _AGGS, "single", 128,
                                      spill=ref_mgr, spill_flush_groups=40)
    got_op = ops.HashAggregation(("g",), _AGGS, "single", 128,
                                 spill=port_mgr, spill_flush_groups=40)
    with ref_kernel_ops.use_backend("jnp"):
        want = _drive_agg(want_op, [r for r, _ in batches])
    got = _drive_agg(got_op, [p for _, p in batches])
    assert port_mgr.stats.host.spills == 5
    assert port_mgr.stats.summary() == ref_mgr.stats.summary()
    assert sorted(got.columns) == sorted(want.columns)
    live_g, live_w = got.validity.numpy(), np.asarray(want.validity)
    og = np.argsort(got.columns["g"].numpy()[live_g])
    ow = np.argsort(np.asarray(want.columns["g"])[live_w])
    for c in want.columns:
        a = got.columns[c].numpy()[live_g][og]
        b = np.asarray(want.columns[c])[live_w][ow]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def _drive_agg(op, batches):
    op.open()
    for b in batches:
        assert op.add_input(b) == []
    (out,) = op.finish()
    return out
