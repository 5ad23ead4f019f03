"""TPC-H queries read from the column-chunk files at SF 0.002 on the CPU:
the port's ``Session(device="cpu")`` over its ``storage_catalog`` against
the reference's ``Session`` over its own and against ``tpch.oracle``, with
zone-map skipping on and off, the synchronous scan baseline
(``streaming=False``), the scan counters of ``executor_stats()``, the host
round trip of a host-only operator, EXPLAIN ANALYZE, and a scan that ends
early or fails."""

import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_diff import assert_same_result  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro.core.session import Session as RefSession  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch.core import batch  # noqa: E402
from repro_torch.core import dtypes as dt  # noqa: E402
from repro_torch.core import operators as port_ops  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.expr import col, lit  # noqa: E402
from repro_torch.core.driver import Driver  # noqa: E402
from repro_torch.core.session import Catalog, Session, TableSource  # noqa: E402
from repro_torch.core.streaming import ScanStats  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.storage import ColumnChunkTable  # noqa: E402
from repro_torch.tpch import dbgen, queries  # noqa: E402

SF = 0.002
CHUNKS = 4
BATCH_ROWS = 8192
# (query, workers): the slice's queries at W = 1 and 2, and the
# reference's end-to-end storage test (Q5 at W = 4)
CASES = [(q, w) for q in (1, 3, 6, 14) for w in (1, 2)] + [(5, 4)]
_COUNTERS = ("morsels", "bytes_read", "bytes_transferred", "chunks_total",
             "chunks_skipped")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    ref_root = str(tmp_path_factory.mktemp("ref_tpch"))
    port_root = str(tmp_path_factory.mktemp("port_tpch"))
    ref_dbgen.write_dataset(ref_root, sf=SF, chunks=CHUNKS)
    data = dbgen.write_dataset(port_root, sf=SF, chunks=CHUNKS)
    return ref_root, port_root, data


def _port_run(root, q, w, **kw):
    catalog = dbgen.storage_catalog(root, kw.pop("skip", True))
    session = Session(catalog, batch_rows=BATCH_ROWS, device="cpu",
                      num_workers=w, **kw)
    out = session.execute(queries.build_query(q, catalog, num_workers=w))
    return out, session.executor_stats()


@pytest.fixture(scope="module")
def ref_runs(roots):
    """The reference's run of each case over its files, skipping on and
    off, under its jnp backend (the same results as pallas, faster)."""
    ref_root = roots[0]
    runs = {}
    for q, w in CASES:
        for skip in (True, False):
            catalog = ref_dbgen.storage_catalog(ref_root, skip)
            session = RefSession(catalog, num_workers=w, batch_rows=BATCH_ROWS,
                                 kernel_backend="jnp")
            out = session.execute(
                ref_queries.build_query(q, catalog, num_workers=w))
            runs[q, w, skip] = (out, session.executor_stats())
    return runs


@pytest.mark.parametrize("q,w", CASES)
def test_query_from_files_matches_reference_and_oracle(roots, ref_runs, q, w):
    _, port_root, data = roots
    got, stats = _port_run(port_root, q, w)
    want, ref_stats = ref_runs[q, w, True]
    assert_same_result(got, want, q)
    assert_results_match(got, oracle.ORACLES[q](data), q)
    assert sorted(stats["tables"]) == sorted(ref_stats["tables"])
    for t, s in stats["tables"].items():
        assert list(s) == list(ref_stats["tables"][t])
        for k in _COUNTERS:
            assert s[k] == ref_stats["tables"][t][k], (t, k)


@pytest.mark.parametrize("q,w", CASES)
def test_skipping_off_gives_identical_results(roots, ref_runs, q, w):
    _, port_root, _ = roots
    on, on_stats = _port_run(port_root, q, w)
    off, off_stats = _port_run(port_root, q, w, skip=False)
    assert sorted(on) == sorted(off)
    for c in on:
        np.testing.assert_array_equal(on[c], off[c], err_msg=c)
    ref_on, ref_off = ref_runs[q, w, True][1], ref_runs[q, w, False][1]
    for t, s in off_stats["tables"].items():
        assert s["chunks_skipped"] == 0
        for k in _COUNTERS:
            assert s[k] == ref_off["tables"][t][k], (t, k)
    assert ({t: s["chunks_skipped"] for t, s in on_stats["tables"].items()}
            == {t: s["chunks_skipped"] for t, s in ref_on["tables"].items()})


@pytest.mark.parametrize("q,w", CASES)
def test_synchronous_scan_equals_streaming(roots, ref_runs, q, w):
    _, port_root, _ = roots
    streamed, _ = _port_run(port_root, q, w)
    synced, stats = _port_run(port_root, q, w, streaming=False)
    assert_same_result(synced, streamed, q)
    ref_stats = ref_runs[q, w, True][1]
    for t, s in stats["tables"].items():
        for k in _COUNTERS:
            assert s[k] == ref_stats["tables"][t][k], (t, k)
        # no prefetch thread: no read or wait time to overlap
        assert s["prefetch_overlap"] == 0.0


def test_q6_skips_lineitem_chunks(roots):
    _, port_root, _ = roots
    _, stats = _port_run(port_root, 6, 1)
    li = stats["tables"]["lineitem"]
    assert 0 < li["chunks_skipped"] < li["chunks_total"] == CHUNKS
    assert li["morsels"] == CHUNKS - li["chunks_skipped"]


@pytest.mark.parametrize("streaming", [True, False])
def test_host_round_trip_counts_conversions(roots, monkeypatch, streaming):
    _, port_root, _ = roots
    want, stats = _port_run(port_root, 1, 2, streaming=streaming)
    assert stats["conversions"] == {}
    received = []
    orig = port_ops.HashAggregation.add_input

    def counted(self, batch):
        received.append(batch.nbytes())
        return orig(self, batch)

    monkeypatch.setattr(port_ops.HashAggregation, "add_input", counted)
    got, stats = _port_run(port_root, 1, 2, streaming=streaming,
                           host_only_ops=frozenset({"HashAggregation"}))
    assert received
    assert stats["conversions"]["bytes"] == 2 * sum(received)
    assert_same_result(got, want, 1)


@pytest.mark.parametrize("q,w,op", [(1, 1, "HashAggregation"),
                                    (1, 2, "HashAggregation"),
                                    (3, 1, "HashAggregation"),
                                    (3, 2, "HashAggregation"),
                                    (3, 1, "HashJoin")])
def test_conversion_bytes_equal_reference(roots, q, w, op):
    """A host-only join's probe does not fuse into the scan: its batches
    take the round trip, as in the reference."""
    ref_root, port_root, _ = roots
    host_only = frozenset({op})
    catalog = ref_dbgen.storage_catalog(ref_root)
    ref = RefSession(catalog, num_workers=w, batch_rows=BATCH_ROWS,
                     kernel_backend="jnp", host_only_ops=host_only)
    want = ref.execute(ref_queries.build_query(q, catalog, num_workers=w))
    got, stats = _port_run(port_root, q, w, host_only_ops=host_only)
    assert_same_result(got, want, q)
    assert stats["conversions"] == ref.executor_stats()["conversions"]


def test_host_only_filter_project_is_run_not_fused(roots):
    _, port_root, data = roots
    got, stats = _port_run(port_root, 6, 1,
                           host_only_ops=frozenset({"FilterProject"}))
    assert_results_match(got, oracle.ORACLES[6](data), 6)
    assert stats["conversions"]["bytes"] > 0
    assert "fused" not in stats["kernel_dispatch"]


def test_explain_analyze_reports_skipping(roots):
    _, port_root, _ = roots
    catalog = dbgen.storage_catalog(port_root)
    session = Session(catalog, batch_rows=BATCH_ROWS, device="cpu",
                      num_workers=2)
    text = session.explain(queries.build_query(6, catalog), analyze=True)
    assert "== executor stats ==" in text and "== memory ==" in text
    line = next(l for l in text.splitlines() if l.startswith("scan lineitem"))
    assert int(line.split("chunks_skipped=")[1].split()[0]) > 0
    li = session.executor_stats()["tables"]["lineitem"]
    assert li["bytes_read"] > 0 and li["bytes_transferred"] > 0
    assert 0.0 <= li["prefetch_overlap"] <= 1.0
    built = session.table("lineitem").filter(col("l_quantity") < lit(3.0))
    assert "scan lineitem" in built.explain(analyze=True)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "morsel-prefetch" and t.is_alive()]


def test_limit_over_storage_stream_terminates(roots):
    _, port_root, _ = roots
    catalog = dbgen.storage_catalog(port_root)
    session = Session(catalog, batch_rows=BATCH_ROWS, device="cpu",
                      num_workers=2)
    res = session.execute(P.Limit(P.TableScan("lineitem",
                                              columns=["l_orderkey"]), 5))
    assert len(res["l_orderkey"]) == 5
    assert not _prefetch_threads()


def test_reader_error_reraises_in_consumer(roots, tmp_path):
    _, port_root, _ = roots
    shutil.copytree(os.path.join(port_root, "lineitem"),
                    str(tmp_path / "lineitem"))
    src = ColumnChunkTable(str(tmp_path), "lineitem", skip_with_stats=False)
    os.remove(str(tmp_path / "lineitem" / src._files[("l_quantity", 2)]))
    catalog = dbgen.storage_catalog(port_root)
    catalog.register(src)
    for streaming in (True, False):
        session = Session(catalog, batch_rows=BATCH_ROWS, device="cpu",
                          streaming=streaming)
        with pytest.raises(FileNotFoundError):
            session.execute(queries.build_query(6, catalog))
    assert not _prefetch_threads()


def test_scan_only_source_still_streams():
    """A source that overrides ``scan`` only (its steps already on the
    device) is prefetched through ``stream`` and runs in the driver."""
    n = 500
    data = {"k": np.arange(n, dtype=np.int32),
            "v": np.linspace(0, 1, n).astype(np.float32)}
    schema = {"k": dt.INT32, "v": dt.FLOAT32}

    class ScanOnly(TableSource):
        name = "scan_only"

        def __init__(self):
            self.schema = schema

        def num_rows(self):
            return n

        def scan(self, columns, batch_rows, device, filter_expr=None,
                 stats=None, num_workers=1):
            cols = list(columns) if columns else list(data)
            for lo in range(0, n, 200):
                yield [TorchTable.from_numpy(
                    {c: data[c][lo:lo + 200] for c in cols},
                    {c: schema[c] for c in cols}, device=device)]

    src = ScanOnly()
    stats = ScanStats()
    got = [t.to_numpy()["k"] for step in src.stream(None, 200, "cpu",
                                                   stats=stats)
           for t in step]
    np.testing.assert_array_equal(np.concatenate(got), data["k"])
    assert stats.morsels == 3 and stats.bytes_transferred > 0
    catalog = Catalog()
    catalog.register(src)
    res = Session(catalog, device="cpu").execute(
        P.TableScan("scan_only", columns=["k"], filter=col("k") < lit(100)))
    np.testing.assert_array_equal(np.sort(res["k"]), np.arange(100))


@pytest.mark.parametrize("streaming", [True, False])
def test_batched_scan_from_files(roots, streaming):
    """A stacked batch of small queries reads the files unfiltered
    (members' predicates differ), streaming or synchronous, and each
    member equals its solo run."""
    _, port_root, _ = roots
    catalog = dbgen.storage_catalog(port_root)
    session = Session(catalog, batch_rows=BATCH_ROWS, device="cpu",
                      streaming=streaming)
    plans = [session.table("lineitem")
             .filter(col("l_quantity") < lit(float(q)))
             .agg(n=("count", None), s=("sum", "l_extendedprice"))
             .optimized() for q in (3, 10, 30)]
    shapes = [batch.extract_shape(p) for p in plans]
    driver = Driver(session.context())
    got = driver.collect_batch(shapes)
    li = driver.executor_stats()["tables"]["lineitem"]
    assert li["chunks_skipped"] == 0 and li["morsels"] == CHUNKS
    for plan, g in zip(plans, got):
        assert_same_result(g, session.execute(plan), 1)
