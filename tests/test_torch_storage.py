"""The port's storage layer (``repro_torch.storage``, ``dbgen.write_dataset``
and ``storage_catalog``) against the reference's, on the CPU at SF 0.002:
the files the writers make, byte for byte; each scan step worker by worker
(worker k's morsel against row k of the reference's ``[W, cap]`` morsel);
the scan counters; the zone-map verdicts on the 22 queries' pushed-down
filters and on generated predicates; and the 22 plans over the two storage
catalogs."""

import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from torch_diff import to_port  # noqa: E402

from repro.core import dtypes as ref_dt  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro.core.expr import BinaryOp as RefBinaryOp  # noqa: E402
from repro.core.expr import ColumnRef as RefColumnRef  # noqa: E402
from repro.core.expr import Literal as RefLiteral  # noqa: E402
from repro.core.expr import col as ref_col  # noqa: E402
from repro.core.expr import date_lit as ref_date_lit  # noqa: E402
from repro.core.expr import lit as ref_lit  # noqa: E402
from repro.core.streaming import ScanStats as RefScanStats  # noqa: E402
from repro.storage import colchunk as ref_colchunk  # noqa: E402
from repro.storage import paged as ref_paged  # noqa: E402
from repro.storage import zonemap as ref_zonemap  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.core.streaming import ScanStats, morsel_to_device  # noqa: E402
from repro_torch.storage import (ColumnChunkTable, PagedTableSource,  # noqa: E402
                                 colchunk, eval_range, may_match, paged,
                                 read_column_chunk, write_paged_table,
                                 write_table, zonemap)
from repro_torch.tpch import dbgen, queries, schema  # noqa: E402

SF = 0.002
CHUNKS = 4
TABLES = sorted(schema.SCHEMAS)
WORKERS = (1, 2, 4)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The reference's and the port's ``write_dataset`` at SF 0.002, with
    lineitem also in the paged format, each written by its own engine."""
    ref_root = str(tmp_path_factory.mktemp("ref_tpch"))
    port_root = str(tmp_path_factory.mktemp("port_tpch"))
    ref_data = ref_dbgen.write_dataset(ref_root, sf=SF, chunks=CHUNKS)
    port_data = dbgen.write_dataset(port_root, sf=SF, chunks=CHUNKS)
    ref_paged.write_paged_table(ref_root, "lineitem", ref_data["lineitem"],
                                ref_dbgen.S.SCHEMAS["lineitem"], row_groups=4)
    write_paged_table(port_root, "lineitem", port_data["lineitem"],
                      schema.SCHEMAS["lineitem"], row_groups=4)
    return ref_root, port_root, ref_data, port_data


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_files(got_root, want_root):
    got, want = _files(got_root), _files(want_root)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# the writers, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", TABLES + ["lineitem.paged"])
def test_write_dataset_bytes_equal_reference(roots, table):
    ref_root, port_root, _, _ = roots
    if table.endswith(".paged"):
        with open(os.path.join(port_root, table), "rb") as f:
            got = f.read()
        with open(os.path.join(ref_root, table), "rb") as f:
            assert got == f.read()
        return
    _assert_same_files(os.path.join(port_root, table),
                       os.path.join(ref_root, table))


def test_write_dataset_returns_the_rows_written(roots):
    _, port_root, ref_data, port_data = roots
    assert sorted(port_data) == sorted(ref_data)
    for t in port_data:
        for c in port_data[t]:
            np.testing.assert_array_equal(port_data[t][c], ref_data[t][c])
    li = port_data["lineitem"]["l_shipdate"]
    assert np.all(np.diff(li) >= 0)            # clustered on CLUSTER_KEYS
    assert dbgen.CLUSTER_KEYS == ref_dbgen.CLUSTER_KEYS


def _synthetic(n, seed=3):
    """Every logical type the formats write, with edge values."""
    rng = np.random.default_rng(seed)
    data = {
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "j": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "f": rng.normal(0, 10, n).astype(np.float32),
        "g": rng.normal(0, 10, n).astype(np.float64),
        "b": rng.random(n) < 0.5,
        "d": rng.integers(8000, 10000, n).astype(np.int32),
        "c": rng.integers(0, 3, n).astype(np.int32),
        "s": rng.integers(32, 127, (n, 5)).astype(np.uint8),
    }
    if n:
        data["i"][0] = np.iinfo(np.int32).min
        data["f"][-1] = -0.0
    ref_schema = {"i": ref_dt.INT32, "j": ref_dt.INT64, "f": ref_dt.FLOAT32,
                  "g": ref_dt.FLOAT64, "b": ref_dt.BOOL, "d": ref_dt.DATE32,
                  "c": ref_dt.dict32(["x", "yy", "zzz"]),
                  "s": ref_dt.bytes_(5)}
    return data, ref_schema


@pytest.mark.parametrize("n,chunks,stats", [(1000, 1, True), (1000, 3, True),
                                            (1000, 3, False), (10, 7, True)])
def test_write_table_bytes_equal_reference(tmp_path, n, chunks, stats):
    data, ref_schema = _synthetic(n)
    ref_colchunk.write_table(str(tmp_path / "ref"), "t", data, ref_schema,
                             chunks=chunks, stats=stats)
    write_table(str(tmp_path / "port"), "t", data, to_port(ref_schema),
                chunks=chunks, stats=stats)
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


@pytest.mark.parametrize("n,row_groups", [(3000, 1), (3000, 4), (5, 8)])
def test_write_paged_table_bytes_equal_reference(tmp_path, n, row_groups):
    data, ref_schema = _synthetic(n)
    ref_paged.write_paged_table(str(tmp_path / "ref"), "t", data, ref_schema,
                                row_groups=row_groups)
    write_paged_table(str(tmp_path / "port"), "t", data, to_port(ref_schema),
                      row_groups=row_groups)
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_empty_chunk_reads_as_dead_rows(tmp_path):
    """n < chunks leaves trailing chunks of 0 rows (files of 0 bytes):
    the port reads them as dead rows."""
    data, ref_schema = _synthetic(10)
    write_table(str(tmp_path), "t", data, to_port(ref_schema), chunks=7)
    src = ColumnChunkTable(str(tmp_path), "t")
    assert src.num_rows() == 10 and src.num_chunks == 7
    assert read_column_chunk(str(tmp_path), "t", "s", 6).shape == (0, 5)
    got = {c: [] for c in data}
    for step in src._host_morsels(None, 8192, num_workers=4):
        for m in step:
            for c in data:
                got[c].append(m.columns[c][m.validity])
    for c in data:
        np.testing.assert_array_equal(np.concatenate(got[c]), data[c])


# ---------------------------------------------------------------------------
# the sources: metadata, steps and counters against the reference
# ---------------------------------------------------------------------------

def _sources(roots, kind, table="lineitem", skip=True):
    ref_root, port_root, _, _ = roots
    if kind == "colchunk":
        return (ref_colchunk.ColumnChunkTable(ref_root, table, skip),
                ColumnChunkTable(port_root, table, skip))
    return (ref_paged.PagedTableSource(ref_root, table, skip),
            PagedTableSource(port_root, table, skip))


@pytest.mark.parametrize("table", TABLES)
def test_colchunk_metadata_equals_reference(roots, table):
    ref, port = _sources(roots, "colchunk", table)
    assert port.num_rows() == ref.num_rows()
    assert port.num_chunks == ref.num_chunks
    assert list(port.schema) == list(ref.schema)
    assert port.schema == to_port(ref.schema)   # dictionaries included
    assert port._chunk_rows == ref._chunk_rows
    assert port._stats == ref._stats


def test_paged_metadata_equals_reference(roots):
    ref, port = _sources(roots, "paged")
    assert port.num_rows() == ref.num_rows()
    assert port.num_chunks == ref.num_chunks
    assert port.footer == ref.footer
    assert port.schema == to_port(ref.schema)
    for g in range(ref.num_chunks):
        for c in ref.schema:
            assert port._get_range(g, c) == ref._get_range(g, c)


def _q6_filter():
    catalog = ref_dbgen.load_catalog(sf=SF)
    return _scan_filters(ref_queries.build_query(6, catalog))[0][1]


def _filter_cases():
    """name -> reference predicate over lineitem (None: no filter)."""
    return {
        "none": None,
        "q6": _q6_filter(),
        "partial": ref_col("l_shipdate") >= ref_date_lit("1997-06-01"),
        "all_skipped": ref_col("l_shipdate") < ref_lit(0),
    }


FILTERS = ("none", "q6", "partial", "all_skipped")
COLUMNS = ["l_shipdate", "l_quantity", "l_returnflag", "l_orderkey"]


def _ref_steps(src, w, columns, expr, stats):
    return list(src._host_morsels(w, columns, 8192, filter_expr=expr,
                                  stats=stats))


def _port_steps(src, w, columns, expr, stats):
    return list(src._host_morsels(columns, 8192, stats=stats, num_workers=w,
                                  filter_expr=to_port(expr)))


def _assert_step_equal(got, want, w):
    assert len(got) == w
    for k, m in enumerate(got):
        assert list(m.columns) == list(want.columns)
        assert m.schema == to_port(want.schema)
        np.testing.assert_array_equal(m.validity, want.validity[k])
        for c, a in m.columns.items():
            assert a.dtype == want.columns[c].dtype, c
            np.testing.assert_array_equal(a, want.columns[c][k], err_msg=c)


@pytest.mark.parametrize("kind", ["colchunk", "paged"])
@pytest.mark.parametrize("w", WORKERS)
@pytest.mark.parametrize("case", FILTERS)
def test_host_morsels_equal_reference(roots, kind, w, case):
    ref_src, port_src = _sources(roots, kind)
    expr = _filter_cases()[case]
    ref_stats, port_stats = RefScanStats(), ScanStats()
    want = _ref_steps(ref_src, w, COLUMNS, expr, ref_stats)
    got = _port_steps(port_src, w, COLUMNS, expr, port_stats)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        _assert_step_equal(g, r, w)
    for field in ("bytes_read", "chunks_total", "chunks_skipped"):
        assert getattr(port_stats, field) == getattr(ref_stats, field), field
    assert port_src.chunks_skipped == ref_src.chunks_skipped
    assert (port_src.bytes_read if kind == "colchunk"
            else port_src.reader.bytes_read) == (
        ref_src.bytes_read if kind == "colchunk" else ref_src.reader.bytes_read)
    if case == "all_skipped":
        # one step of capacity-1 dead morsels keeps the operators fed
        assert port_stats.chunks_skipped == port_src.num_chunks
        assert len(got) == 1
        assert all(m.validity.shape == (1,) and not m.validity.any()
                   for m in got[0])
    if case in ("q6", "partial"):
        assert 0 < port_stats.chunks_skipped < port_src.num_chunks


@pytest.mark.parametrize("kind", ["colchunk", "paged"])
def test_all_columns_and_skipping_off_equal_reference(roots, kind):
    """``columns=None`` reads every column in the reference's order, and
    with skipping off a refuting filter reads every chunk."""
    ref_src, port_src = _sources(roots, kind, skip=False)
    expr = _filter_cases()["all_skipped"]
    want = _ref_steps(ref_src, 2, None, expr, None)
    got = _port_steps(port_src, 2, None, expr, None)
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        _assert_step_equal(g, r, 2)
    assert port_src.chunks_skipped == ref_src.chunks_skipped == 0


def test_bytes_read_counts_surviving_chunks(roots):
    _, port_root, _, port_data = roots
    src = ColumnChunkTable(port_root, "lineitem")
    stats = ScanStats()
    expr = to_port(_filter_cases()["partial"])
    list(src._host_morsels(COLUMNS, 8192, stats=stats, filter_expr=expr))
    live = [k for k in range(src.num_chunks) if src._chunk_survives(k, expr)]
    want = sum(src._chunk_rows[k] * port_data["lineitem"][c].itemsize
               for k in live for c in COLUMNS)
    assert stats.bytes_read == src.bytes_read == want


@pytest.mark.parametrize("kind", ["colchunk", "paged"])
def test_cpu_morsels_own_writable_memory(roots, kind):
    _, port_src = _sources(roots, kind)
    for step in port_src._host_morsels(None, 8192, num_workers=2):
        for m in step:
            for a in list(m.columns.values()) + [m.validity]:
                assert a.flags.writeable and a.flags.owndata
                assert not isinstance(a, np.memmap)
            with warnings.catch_warnings():
                # torch.from_numpy warns on a read-only array
                warnings.simplefilter("error")
                table = morsel_to_device(m, "cpu")
            for t in list(table.columns.values()) + [table.validity]:
                t.copy_(t.clone())          # a write faults on read-only pages


@pytest.mark.parametrize("table,column", [("lineitem", "l_orderkey"),
                                          ("lineitem", "l_returnflag"),
                                          ("customer", "c_name")])
def test_read_column_chunk_equals_reference(roots, table, column):
    ref_root, port_root, _, _ = roots
    for k in range(CHUNKS):
        got = read_column_chunk(port_root, table, column, k)
        want = ref_colchunk.read_column_chunk(ref_root, table, column, k)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# zone maps
# ---------------------------------------------------------------------------

def _scan_filters(plan):
    """(table, filter) of every TableScan with a pushed-down filter."""
    out = []
    if isinstance(plan, ref_plan.TableScan) or type(plan).__name__ == "TableScan":
        if plan.filter is not None:
            out.append((plan.table, plan.filter))
    for child in plan.children():
        out.extend(_scan_filters(child))
    return out


def _chunk_ranges(src, chunk):
    def get_range(c):
        entry = src._stats["stats"].get(c)
        if not entry or entry[chunk] is None:
            return None
        return tuple(entry[chunk])
    return get_range


@pytest.mark.parametrize("q", range(1, 23))
def test_eval_range_on_pushed_down_filters(roots, q):
    ref_root, _, _, _ = roots
    catalog = ref_dbgen.storage_catalog(ref_root)
    for table, expr in _scan_filters(ref_queries.build_query(q, catalog)):
        src = catalog.get(table)
        port_expr = to_port(expr)
        for k in range(src.num_chunks):
            rng = _chunk_ranges(src, k)
            assert eval_range(port_expr, rng) == ref_zonemap.eval_range(expr, rng)
            assert may_match(port_expr, rng) == ref_zonemap.may_match(expr, rng)


_OPS = ("lt", "le", "gt", "ge", "eq", "ne", "add")
_COLS = ("a", "b", "nostats")
_RANGES = {"a": (10.0, 20.0), "b": (-5.0, 5.0), "nostats": None}


def _leaf(draw):
    op = draw(st.sampled_from(_OPS))
    c = RefColumnRef(draw(st.sampled_from(_COLS)))
    kind = draw(st.sampled_from(("int", "float", "bytes")))
    if kind == "bytes":             # float() of a non-numeric value fails
        v = RefLiteral(b"abc", ref_dt.bytes_(3))
    elif kind == "int":
        v = RefLiteral(draw(st.integers(-10, 25)))
    else:
        v = RefLiteral(draw(st.floats(-10, 25, allow_nan=False)))
    flipped = draw(st.booleans())
    return RefBinaryOp(op, v, c) if flipped else RefBinaryOp(op, c, v)


@st.composite
def _predicates(draw, depth=3):
    if depth == 0 or draw(st.booleans()):
        return _leaf(draw)
    op = draw(st.sampled_from(("and", "or")))
    return RefBinaryOp(op, draw(_predicates(depth - 1)),
                       draw(_predicates(depth - 1)))


@settings(max_examples=300, deadline=None)
@given(_predicates())
def test_eval_range_matches_reference_on_generated_predicates(expr):
    get_range = _RANGES.get
    assert (zonemap.eval_range(to_port(expr), get_range)
            == ref_zonemap.eval_range(expr, get_range))
    assert (zonemap.may_match(to_port(expr), get_range)
            == ref_zonemap.may_match(expr, get_range))


def test_may_match_none_filter():
    assert may_match(None, _RANGES.get) is True


# ---------------------------------------------------------------------------
# plans over the storage catalogs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", range(1, 23))
def test_plan_fingerprint_over_storage_matches_reference(roots, q):
    ref_root, port_root, _, _ = roots
    port = queries.build_query(q, dbgen.storage_catalog(port_root))
    ref = ref_queries.build_query(q, ref_dbgen.storage_catalog(ref_root))
    assert port_plan.fingerprint(port) == ref_plan.fingerprint(ref)


def test_storage_catalog_keys_and_sources(roots):
    _, port_root, _, _ = roots
    cat = dbgen.storage_catalog(port_root, skip_with_stats=False)
    assert sorted(cat.tables()) == TABLES
    for t in TABLES:
        src = cat.get(t)
        assert isinstance(src, colchunk.ColumnChunkTable)
        assert src.unique_keys == (schema.PRIMARY_KEYS[t],)
        assert src.skip_with_stats is False


def test_scan_stats_summary_keys_equal_reference():
    assert list(ScanStats().summary()) == list(RefScanStats().summary())
    assert [f.name for f in dataclasses.fields(ScanStats)] == [
        f.name for f in dataclasses.fields(RefScanStats)]


def test_paged_reader_reads_whole_columns(roots):
    _, port_root, _, port_data = roots
    reader = paged.PagedTable(port_root, "lineitem")
    for c in ("l_orderkey", "l_extendedprice", "l_shipmode"):
        np.testing.assert_array_equal(reader.read_column(c),
                                      port_data["lineitem"][c])
