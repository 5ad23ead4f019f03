"""The port's SQL frontend (``repro_torch.core.sqlast``, ``core.sql``,
``tpch.sqltext``, ``Session.sql``) against the reference's, on the CPU at
SF 0.002.

* The tokenizer and parser give the reference's tokens and tree on the
  20 TPC-H texts and on every golden and loud-failure text of
  ``tests/test_sql_frontend.py``; a text the reference refuses, the port
  refuses with the same error class and message.
* Each text lowers to an optimized plan whose fingerprint equals the
  reference's.
* The 20 texts run through ``Session(device="cpu").sql(...)`` and match
  the reference's numpy oracle, optimized and not.
* The unified API of ``TestUnifiedApi``: options attached at ``sql``,
  ``optimize=False``, the ``sql=`` cache-key prefix and its result-cache
  hit, explain delegation.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from tpch_util import assert_results_match  # noqa: E402
from torch_diff import port_catalog  # noqa: E402

from repro.core import plan as ref_plan  # noqa: E402
from repro.core import sqlast as ref_sqlast  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import sqltext as ref_sqltext  # noqa: E402
from repro_torch.core import plan as port_plan  # noqa: E402
from repro_torch.core import sqlast  # noqa: E402
from repro_torch.core.builder import SchemaError, table  # noqa: E402
from repro_torch.core.expr import col, lit  # noqa: E402
from repro_torch.core.session import ExecutionOptions, Session  # noqa: E402
from repro_torch.tpch import sqltext  # noqa: E402

SF = 0.002

# the golden texts of tests/test_sql_frontend.py
GOLDEN = (
    "SELECT l_orderkey, l_extendedprice * (1.0 - l_discount) AS rev "
    "FROM lineitem WHERE l_quantity < 24.0",
    "SELECT l_returnflag, sum(l_quantity) AS sum_qty, count(*) AS n "
    "FROM lineitem GROUP BY l_returnflag",
    "SELECT o_orderdate, l_extendedprice FROM lineitem, orders "
    "WHERE l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'",
    "SELECT count(*) AS n FROM orders WHERE o_custkey IN "
    "(SELECT c_custkey FROM customer WHERE c_acctbal > 0.0)",
    "SELECT count(*) AS n FROM customer WHERE NOT EXISTS "
    "(SELECT * FROM orders WHERE o_custkey = c_custkey)",
    "SELECT o_orderkey, o_totalprice FROM orders "
    "ORDER BY o_totalprice DESC LIMIT 10",
    "SELECT l_returnflag, sum(l_quantity) AS q FROM lineitem "
    "WHERE l_shipdate <= DATE '1998-09-02' GROUP BY l_returnflag",
    "SELECT count(*) AS n FROM orders",
    "SELECT o_orderkey FROM orders WHERE o_orderkey <= 32 ORDER BY o_orderkey",
    "SELECT count(*) AS n FROM customer",
    "SELECT count(*) AS n FROM nation",
    "SELECT n_nationkey FROM nation ORDER BY n_nationkey LIMIT 3",
    # the SQL reaches of this slice: LIKE and EXTRACT(YEAR) in one run
    "SELECT o_orderkey, EXTRACT(YEAR FROM o_orderdate) AS y FROM orders "
    "WHERE EXTRACT(YEAR FROM o_orderdate) = 1995 "
    "AND o_comment LIKE '%special%requests%'",
)
# the loud-failure texts, and the needle each error names
LOUD = (
    ("SELECT * FROM lineitem FULL OUTER JOIN orders "
     "ON l_orderkey = o_orderkey", "FULL"),
    ("SELECT l_orderkey, sum(l_quantity) OVER () FROM lineitem", "OVER"),
    ("SELECT * FROM lineitem, orders", "cross join"),
    ("SELECT p_name FROM part WHERE p_name LIKE 'x_y'", "_"),
    ("SELECT count(*) AS n FROM orders o1, orders o2 "
     "WHERE o1.o_custkey = o2.o_custkey", "unique"),
    ("SELEC oops FROM lineitem", "SELEC"),
    ("SELECT nope FROM lineitem", "nope"),
)


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=SF)


@pytest.fixture(scope="module")
def ref_catalog():
    return ref_dbgen.load_catalog(sf=SF)


@pytest.fixture(scope="module")
def catalog(data):
    return port_catalog(data)


@pytest.fixture(scope="module")
def session(catalog):
    return Session(catalog, batch_rows=16384, device="cpu")


@pytest.fixture(scope="module")
def ref_session(ref_catalog):
    return RefSession(ref_catalog, batch_rows=16384)


def _tree(v):
    """A parse tree, token list or value as nested tuples of class names
    and fields (the two packages' classes share names and fields)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, _tree(getattr(v, f.name))) for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple)):
        return tuple(_tree(x) for x in v)
    return v


def _texts(ref_catalog):
    return [ref_sqltext.sql_text(q, ref_catalog)
            for q in ref_sqltext.SUPPORTED] + list(GOLDEN)


def test_texts_are_the_references(catalog, ref_catalog):
    assert sqltext.SUPPORTED == ref_sqltext.SUPPORTED
    assert sqltext.UNSUPPORTED == ref_sqltext.UNSUPPORTED
    for q in sqltext.SUPPORTED:
        assert sqltext.sql_text(q, catalog) == ref_sqltext.sql_text(
            q, ref_catalog), q
    for q in sqltext.UNSUPPORTED:
        with pytest.raises(KeyError):
            sqltext.sql_text(q, catalog)


def test_tokens_and_trees_equal_the_references(ref_catalog):
    for text in _texts(ref_catalog) + [t for t, _ in LOUD[:-2]]:
        assert _tree(sqlast.tokenize(text)) == _tree(
            ref_sqlast.tokenize(text)), text
        try:
            want = ref_sqlast.parse(text)
        except ref_sqlast.SqlUnsupportedError as exc:
            with pytest.raises(sqlast.SqlUnsupportedError) as got:
                sqlast.parse(text)
            assert str(got.value) == str(exc)
            continue
        assert _tree(sqlast.parse(text)) == _tree(want), text


@pytest.mark.parametrize("k", range(len(LOUD)))
def test_loud_failures_match_the_reference(k, session, ref_session):
    text, needle = LOUD[k]
    with pytest.raises(Exception) as want:
        ref_session.sql(text).collect()
    with pytest.raises(Exception) as got:
        session.sql(text).collect()
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__name__ in ("SqlUnsupportedError",
                                        "SqlParseError", "SchemaError")
    assert str(got.value) == str(want.value)
    assert needle.lower() in str(got.value).lower()
    if type(got.value).__name__ == "SchemaError":
        assert isinstance(got.value, SchemaError)


def test_dialect_needs_sqlglot(session):
    # sqlglot is on neither machine: a dialect request fails loudly
    try:
        import sqlglot  # noqa: F401
    except ImportError:
        with pytest.raises(sqlast.SqlUnsupportedError, match="sqlglot"):
            session.sql("SELECT count(*) AS n FROM nation",
                        dialect="postgres")
    else:
        pytest.fail("sqlglot is installed; this test pins its absence")


def test_fingerprints_equal_the_references(session, ref_session,
                                           ref_catalog):
    for text in _texts(ref_catalog):
        got = session.sql(text)
        want = ref_session.sql(text)
        assert got.sql_text == text
        assert port_plan.fingerprint(got.plan) == ref_plan.fingerprint(
            want.plan), text
        assert port_plan.fingerprint(session.optimize(got.plan)) == \
            ref_plan.fingerprint(ref_session.optimize(want.plan)), text


def test_golden_lowering_equals_the_hand_built_query(session, catalog):
    sql = session.sql(GOLDEN[0])
    hand = (table(catalog, "lineitem")
            .filter(col("l_quantity") < lit(24.0))
            .project("l_orderkey",
                     rev=col("l_extendedprice") * (lit(1.0)
                                                   - col("l_discount"))))
    assert port_plan.fingerprint(session.optimize(sql.plan)) == \
        port_plan.fingerprint(session.optimize(hand.plan))


@pytest.mark.parametrize("optimize", [True, False])
def test_tpch_texts_match_the_oracle(optimize, session, catalog, data):
    opts = ExecutionOptions(optimize=optimize)
    for q in sqltext.SUPPORTED:
        out = session.sql(sqltext.sql_text(q, catalog), options=opts).collect()
        assert_results_match(out, oracle.ORACLES[q](data), q)


class TestUnifiedApi:
    def test_options_num_workers_collect(self, session, catalog, data):
        res = session.sql(sqltext.sql_text(6, catalog)).collect(
            options=ExecutionOptions(num_workers=2))
        assert_results_match(res, oracle.ORACLES[6](data), 6)

    def test_options_attached_at_sql(self, session):
        q = session.sql("SELECT count(*) AS n FROM orders",
                        options=ExecutionOptions(num_workers=2))
        base = session.sql("SELECT count(*) AS n FROM orders").collect()
        assert q.collect()["n"] == base["n"]

    def test_options_optimize_false(self, session):
        out = session.sql(
            "SELECT o_orderkey FROM orders WHERE o_orderkey <= 32 "
            "ORDER BY o_orderkey").collect(
                options=ExecutionOptions(optimize=False))
        keys = out["o_orderkey"]
        assert len(keys) > 0 and keys.max() <= 32
        assert list(keys) == sorted(keys)

    def test_feedback_option_cold_then_warm(self, session):
        from repro_torch.core.feedback import FeedbackStore
        text = ("SELECT o_orderpriority, count(*) AS n FROM orders "
                "GROUP BY o_orderpriority ORDER BY o_orderpriority")
        once = session.sql(text, options=ExecutionOptions(
            feedback=True)).collect()          # an ephemeral store
        store = FeedbackStore()
        q = session.sql(text, options=ExecutionOptions(feedback=store))
        cold = q.collect()
        assert len(store) > 0
        hits = store.summary()["hits"]
        warm = q.collect()
        assert store.summary()["hits"] > hits  # planned from observations
        for out in (cold, warm):
            assert list(out) == list(once)
            for c in once:
                np.testing.assert_array_equal(out[c], once[c])

    def test_builder_collect_shim(self, session):
        out = session.table("orders").agg(n=("count", None)).collect(True)
        assert int(out["n"][0]) > 0

    def test_run_shim_accepts_plan_and_builder(self, session):
        qb = session.table("orders").agg(n=("count", None))
        assert session.run(qb.plan)["n"] == session.run(qb)["n"]

    def test_submit_options_and_sql_cache_prefix(self, catalog):
        session = Session(catalog, batch_rows=16384, device="cpu")
        text = "SELECT count(*) AS n FROM customer"
        h1 = session.sql(text).submit(
            options=ExecutionOptions(priority=3, num_workers=2))
        r1 = h1.result()
        assert h1.num_workers == 2 and h1.priority == 3
        assert h1._result_key.startswith("sql=")
        assert ":w2:" in h1._result_key
        # identical text and options: a result-cache hit under the same key
        h2 = session.sql(text).submit(options=ExecutionOptions(num_workers=2))
        assert h2.result()["n"] == r1["n"]
        assert h2.cache_hit
        # the same logical plan without SQL text keys apart
        h3 = session.table("customer").agg(n=("count", None)) \
            .project("n").submit()
        assert not h3._result_key.startswith("sql=")
        assert h3.result()["n"] == r1["n"]
        cache = session.scheduler().result_cache
        assert len(cache) == 2
        cache.invalidate(h1._result_key)
        assert len(cache) == 1
        h4 = session.sql(text).submit(options=ExecutionOptions(num_workers=2))
        assert not h4.cache_hit and h4.result()["n"] == r1["n"]
        session.reset_scheduler()

    def test_explain_delegates_to_session(self, session):
        q = session.sql("SELECT count(*) AS n FROM nation")
        txt = q.explain()
        assert "TableScan" in txt or "Aggregation" in txt
        analyzed = q.explain(analyze=True)
        assert "== executor stats ==" in analyzed

    def test_explain_unbound_analyze_raises(self, catalog):
        qb = table(catalog, "nation").agg(n=("count", None))
        assert "Aggregation" in qb.explain()
        with pytest.raises(RuntimeError, match="session.sql"):
            qb.explain(analyze=True)

    def test_sql_results_are_numpy(self, session):
        out = session.sql("SELECT n_nationkey FROM nation "
                          "ORDER BY n_nationkey LIMIT 3").collect()
        assert isinstance(out["n_nationkey"], np.ndarray)
        assert list(out["n_nationkey"]) == [0, 1, 2]


def test_composite_join_takes_the_sorted_key_path(session, data,
                                                  monkeypatch):
    """The composite join of ``chip_smoke.py``'s SQL phase: at SF 1 its two
    key columns' windows do not pack into 31 bits, so it runs on the
    sorted-key path. Here they pack, so a cap below the table sends it
    there; either way its count is the exact one, from numpy."""
    from repro_torch.core import operators
    text = ("SELECT count(*) AS n FROM lineitem, orders "
            "WHERE l_orderkey = o_orderkey AND l_suppkey = o_custkey")
    li, od = data["lineitem"], data["orders"]
    pairs = set(zip(od["o_orderkey"].tolist(), od["o_custkey"].tolist()))
    want = sum((k, s) in pairs for k, s in zip(li["l_orderkey"].tolist(),
                                               li["l_suppkey"].tolist()))
    assert int(session.sql(text).collect()["n"][0]) == want
    assert "fallback_probe" not in session.executor_stats()["kernel_dispatch"]
    monkeypatch.setattr(operators, "MAX_HASH_TABLE_SLOTS", 2)
    assert int(session.sql(text).collect()["n"][0]) == want
    assert session.executor_stats()["kernel_dispatch"]["fallback_probe"] == 1


def test_sql_born_batch_program_lowers_like_and_year(session, catalog):
    """Texts of one template with EXTRACT(YEAR) and LIKE, differing only in
    literals, share one batch program; its lowering holds YEAR and
    BYTESMATCH, and through the kernel emulator equals the plain version
    on an orders morsel."""
    import torch
    from torch_diff import assert_tables_equal, emulate_batch

    from repro_torch.core import batch, fused
    from repro_torch.core.table import TorchTable

    texts = [("SELECT count(*) AS n, sum(o_totalprice) AS total FROM orders "
              f"WHERE EXTRACT(YEAR FROM o_orderdate) = {1992 + j % 7} AND "
              "o_comment LIKE '%special%requests%' AND o_totalprice > "
              f"{1000.0 * (j + 1)}") for j in range(5)]
    shapes = [batch.extract_shape(session.sql(t).optimized()) for t in texts]
    prog = shapes[0].program
    assert all(s is not None and s.program is prog for s in shapes)
    src = catalog.get("orders")
    table = TorchTable.from_numpy({c: src.data[c] for c in prog.columns},
                                  {c: src.schema[c] for c in prog.columns},
                                  device="cpu")
    lowered = prog.lowered(table)
    ops = set(lowered.code[:, 0].tolist())
    assert {fused.OPS["YEAR"], fused.OPS["BYTESMATCH"]} <= ops
    params = batch._params(prog, shapes, 5, torch.device("cpu"))
    want, want_masks = fused.apply_batched_stages(table, prog.pre_stages,
                                                  params, 5)
    got, masks = emulate_batch(lowered, table, params, 5)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())
    assert want_masks.any()
