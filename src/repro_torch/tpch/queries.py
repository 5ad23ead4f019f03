"""TPC-H query plans for the port.

Each function returns the plan that the reference's optimizer makes of its
query (``repro.tpch.queries.build_query(q, catalog)``), spelled out node by
node, so the two fingerprint identically: the filter pushed into the scan,
the scan's column list, the capacities. The joins' ``build_rows`` and the
group-bys' ``max_groups`` are derived from the catalog's row counts as the
reference's ``optimizer.derive_capacities`` derives them. The builder and
optimizer are ported in a later slice; until then the queries of each
slice are written here.
"""

from __future__ import annotations

from ..core import plan as P
from ..core.dtypes import date_to_i32
from ..core.expr import col, date_lit, lit
from . import schema as S

# the optimizer's largest derived capacity (reference optimizer.py:51)
MAX_CAPACITY = 1 << 24
_GROUP_SLACK = 8


def _pow2(n: int) -> int:
    return 1 << (max(n, 2) - 1).bit_length()


def _rows(catalog, table: str) -> int:
    return int(catalog.get(table).num_rows())


def _build_rows(rows: int):
    """A join's ``build_rows``: its build side's row bound, when it is in
    the planner's budget (else the planner leaves it unset)."""
    return rows if rows <= MAX_CAPACITY else None


def _max_groups(rows: int) -> int:
    """A group-by's ``max_groups`` over ``rows`` input rows with no finite
    key domain: pow2(rows + slack) when in budget, else the default."""
    mg = _pow2(rows + _GROUP_SLACK)
    return mg if mg <= MAX_CAPACITY else 4096


def q1(catalog) -> P.PlanNode:
    """Pricing summary report: lineitem grouped by return flag and status."""
    del catalog
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    scan = P.TableScan(
        "lineitem",
        columns=["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate"],
        filter=col("l_shipdate") <= lit(date_to_i32("1998-12-01") - 90))
    keep = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount"]
    project = P.Project(scan, [(c, col(c)) for c in keep]
                        + [("disc_price", disc_price), ("charge", charge)])
    agg = P.Aggregation(
        project, ["l_returnflag", "l_linestatus"],
        [("sum_qty", "sum", "l_quantity"),
         ("sum_base_price", "sum", "l_extendedprice"),
         ("sum_disc_price", "sum", "disc_price"),
         ("sum_charge", "sum", "charge"),
         ("avg_qty", "avg", "l_quantity"),
         ("avg_price", "avg", "l_extendedprice"),
         ("avg_disc", "avg", "l_discount"),
         ("count_order", "count", None)],
        max_groups=16)
    return P.OrderBy(agg, ["l_returnflag", "l_linestatus"])


def q6(catalog) -> P.PlanNode:
    """Forecasting revenue change: one filtered global sum over lineitem."""
    del catalog
    pred = (col("l_shipdate").between(date_lit("1994-01-01"),
                                      lit(date_to_i32("1995-01-01") - 1))
            & col("l_discount").between(0.05, 0.07)
            & (col("l_quantity") < 24.0))
    scan = P.TableScan(
        "lineitem",
        columns=["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"],
        filter=pred)
    project = P.Project(scan, [("v", col("l_extendedprice")
                                * col("l_discount"))])
    return P.Aggregation(project, [], [("revenue", "sum", "v")], max_groups=1)


def _revenue():
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


def q3(catalog) -> P.PlanNode:
    """Shipping priority: lineitem joined to orders of BUILDING customers,
    revenue per order, top 10."""
    n_li = _rows(catalog, "lineitem")
    cust = P.TableScan(
        "customer", columns=["c_custkey", "c_mktsegment"],
        filter=col("c_mktsegment") == lit(S.SEGMENTS.index("BUILDING")))
    orders = P.Join(
        P.TableScan("orders",
                    columns=["o_orderkey", "o_custkey", "o_orderdate",
                             "o_shippriority"],
                    filter=col("o_orderdate") < date_lit("1995-03-15")),
        cust, ["o_custkey"], ["c_custkey"], join_type="left_semi",
        build_rows=_build_rows(_rows(catalog, "customer")))
    joined = P.Join(
        P.TableScan("lineitem",
                    columns=["l_orderkey", "l_extendedprice", "l_discount",
                             "l_shipdate"],
                    filter=col("l_shipdate") > date_lit("1995-03-15")),
        orders, ["l_orderkey"], ["o_orderkey"],
        build_payload=["o_orderdate", "o_shippriority"],
        build_rows=_build_rows(_rows(catalog, "orders")))
    project = P.Project(joined, [("l_orderkey", col("l_orderkey")),
                                 ("o_orderdate", col("o_orderdate")),
                                 ("o_shippriority", col("o_shippriority")),
                                 ("rev", _revenue())])
    agg = P.Aggregation(project, ["l_orderkey"],
                        [("revenue", "sum", "rev"),
                         ("o_orderdate", "first", "o_orderdate"),
                         ("o_shippriority", "first", "o_shippriority")],
                        max_groups=_max_groups(n_li))
    return P.OrderBy(agg, ["revenue", "o_orderdate"], [True, False],
                     limit=10)


def q10(catalog) -> P.PlanNode:
    """Returned item reporting: revenue lost to returns per customer in one
    quarter, with the customer's details and nation, top 20."""
    n_li = _rows(catalog, "lineitem")
    orders = P.TableScan(
        "orders", columns=["o_orderkey", "o_custkey", "o_orderdate"],
        filter=col("o_orderdate").between(
            date_lit("1993-10-01"), lit(date_to_i32("1994-01-01") - 1)))
    joined = P.Join(
        P.TableScan("lineitem",
                    columns=["l_orderkey", "l_extendedprice", "l_discount",
                             "l_returnflag"],
                    filter=col("l_returnflag") == lit(
                        S.RETURNFLAGS.index("R"))),
        orders, ["l_orderkey"], ["o_orderkey"], build_payload=["o_custkey"],
        build_rows=_build_rows(_rows(catalog, "orders")))
    rev = P.Aggregation(
        P.Project(joined, [("o_custkey", col("o_custkey")),
                           ("rev", _revenue())]),
        ["o_custkey"], [("revenue", "sum", "rev")],
        max_groups=_max_groups(n_li))
    cust = P.TableScan("customer", columns=[
        "c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
        "c_acctbal", "c_comment"])
    with_rev = P.Join(cust, rev, ["c_custkey"], ["o_custkey"],
                      build_payload=["revenue"],
                      build_rows=_build_rows(n_li))
    with_nation = P.Join(
        with_rev, P.TableScan("nation", columns=["n_nationkey", "n_name"]),
        ["c_nationkey"], ["n_nationkey"], build_payload=["n_name"],
        build_rows=_build_rows(_rows(catalog, "nation")))
    out = ["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
           "c_address", "c_phone", "c_comment"]
    return P.OrderBy(P.Project(with_nation, [(c, col(c)) for c in out]),
                     ["revenue"], [True], limit=20)


QUERIES = {1: q1, 3: q3, 6: q6, 10: q10}
