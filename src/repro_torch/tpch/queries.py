"""TPC-H query plans for the port.

Each function returns the plan that the reference's optimizer makes of its
query (``repro.tpch.queries.build_query(q, catalog)``), spelled out node by
node, so the two fingerprint identically: the filter pushed into the scan,
the scan's column list, Q1's ``max_groups=16``. The builder and optimizer
are ported in a later slice; until then the queries of each slice are
written here.
"""

from __future__ import annotations

from ..core import plan as P
from ..core.dtypes import date_to_i32
from ..core.expr import col, date_lit, lit


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


QUERIES = {1: q1, 6: q6}
