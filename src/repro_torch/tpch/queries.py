"""All 22 TPC-H queries (the port's copy of ``repro.tpch.queries``).

Queries describe *logical* plans only: no capacity hints, no distribution
choices. ``build_query`` runs every plan through the port's copy of the
rule-based optimizer (``repro_torch.core.optimizer``), which pushes
predicates into scans, prunes unreferenced columns, picks join
distributions, and derives the static-shape capacity hints
(``max_groups``/``max_matches``/``build_rows``) from catalog statistics, so
each optimized plan fingerprints exactly like the reference's.

Q1, Q3, Q5, Q6, Q10 and Q14 are written in the fluent builder API
(``repro_torch.core.builder``); the remaining queries are hand-assembled
``PlanNode`` trees (correlated/EXISTS subqueries rewritten into joins the
way Presto's planner does).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from ..core import plan as P
from ..core.builder import table as _t
from ..core.expr import col, date_lit, lit, prefix_code, year
from ..core.optimizer import DEFAULT_CONFIG, optimize
from . import schema as S

_D = date_lit


def _dict_code(schema_col, value: str) -> int:
    return schema_col.dictionary.index(value)


def _nation(name: str) -> int:
    return S.NATIONS.index(name)


def _region(name: str) -> int:
    return S.REGIONS.index(name)


# ---------------------------------------------------------------------------

def q1(catalog) -> P.PlanNode:
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (
        _t(catalog, "lineitem")
        .filter(col("l_shipdate") <= lit(_D("1998-12-01").value - 90))
        .project("l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount",
                 disc_price=disc_price, charge=charge)
        .group_by("l_returnflag", "l_linestatus")
        .agg(sum_qty=("sum", "l_quantity"),
             sum_base_price=("sum", "l_extendedprice"),
             sum_disc_price=("sum", "disc_price"),
             sum_charge=("sum", "charge"),
             avg_qty=("avg", "l_quantity"),
             avg_price=("avg", "l_extendedprice"),
             avg_disc=("avg", "l_discount"),
             count_order=("count", None))
        .order_by("l_returnflag", "l_linestatus")
        .to_plan())


def q2(catalog) -> P.PlanNode:
    eu_nation = P.Join(
        probe=P.TableScan("nation"),
        build=P.Filter(P.TableScan("region"),
                       col("r_name") == lit(_region("EUROPE"))),
        probe_keys=["n_regionkey"], build_keys=["r_regionkey"],
        join_type="left_semi")
    eu_supp = P.Join(
        probe=P.TableScan("supplier"),
        build=eu_nation,
        probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        build_payload=["n_name"])
    ps_eu = P.Join(
        probe=P.TableScan("partsupp"),
        build=eu_supp,
        probe_keys=["ps_suppkey"], build_keys=["s_suppkey"],
        build_payload=["s_acctbal", "s_name", "s_address", "s_phone",
                       "s_comment", "n_name"])
    parts_f = P.Filter(
        P.TableScan("part"),
        (col("p_size") == lit(15)) & _type_endswith_brass())
    joined = P.Join(probe=ps_eu, build=parts_f,
                    probe_keys=["ps_partkey"], build_keys=["p_partkey"],
                    build_payload=["p_mfgr"])
    min_cost = P.Aggregation(joined, ["ps_partkey"],
                             [("min_cost", "min", "ps_supplycost")])
    final = P.Filter(
        P.Join(probe=joined, build=min_cost,
               probe_keys=["ps_partkey"], build_keys=["ps_partkey"],
               build_payload=["min_cost"]),
        col("ps_supplycost") == col("min_cost"))
    return P.OrderBy(
        P.Project(final, [("s_acctbal", col("s_acctbal")),
                          ("s_name", col("s_name")),
                          ("n_name", col("n_name")),
                          ("p_partkey", col("ps_partkey")),
                          ("p_mfgr", col("p_mfgr")),
                          ("s_address", col("s_address")),
                          ("s_phone", col("s_phone")),
                          ("s_comment", col("s_comment"))]),
        keys=["s_acctbal", "n_name", "s_name", "p_partkey"],
        descending=[True, False, False, False], limit=100)


def _type_endswith_brass():
    # p_type is dictionary encoded; LIKE '%BRASS' = membership in the codes
    # whose decoded string ends with BRASS (planner constant-folds this)
    codes = [i for i, t in enumerate(S.TYPES) if t.endswith("BRASS")]
    return col("p_type").isin(codes)


def q3(catalog) -> P.PlanNode:
    cust = (_t(catalog, "customer")
            .filter(col("c_mktsegment") == lit(_dict_code(
                S.CUSTOMER["c_mktsegment"], "BUILDING"))))
    orders = (_t(catalog, "orders")
              .filter(col("o_orderdate") < _D("1995-03-15"))
              .semi_join(cust, ["o_custkey"], ["c_custkey"]))
    return (
        _t(catalog, "lineitem")
        .filter(col("l_shipdate") > _D("1995-03-15"))
        .join(orders, ["l_orderkey"], ["o_orderkey"],
              payload=["o_orderdate", "o_shippriority"])
        .project("l_orderkey", "o_orderdate", "o_shippriority",
                 rev=col("l_extendedprice") * (lit(1.0) - col("l_discount")))
        .group_by("l_orderkey")
        .agg(revenue=("sum", "rev"),
             o_orderdate=("first", "o_orderdate"),
             o_shippriority=("first", "o_shippriority"))
        .order_by("revenue", "o_orderdate", descending=[True, False], limit=10)
        .to_plan())


def q4(catalog) -> P.PlanNode:
    late = P.Filter(P.TableScan("lineitem"),
                    col("l_commitdate") < col("l_receiptdate"))
    orders = P.Filter(P.TableScan("orders"),
                      col("o_orderdate").between(_D("1993-07-01"),
                                                 lit(_D("1993-10-01").value - 1)))
    semi = P.Join(probe=orders, build=late, probe_keys=["o_orderkey"],
                  build_keys=["l_orderkey"], join_type="left_semi")
    return P.OrderBy(
        P.Aggregation(semi, ["o_orderpriority"],
                      [("order_count", "count", None)]),
        keys=["o_orderpriority"])


def q5(catalog) -> P.PlanNode:
    asia_nation = (_t(catalog, "nation")
                   .semi_join(_t(catalog, "region")
                              .filter(col("r_name") == lit(_region("ASIA"))),
                              ["n_regionkey"], ["r_regionkey"]))
    supp = (_t(catalog, "supplier")
            .join(asia_nation, ["s_nationkey"], ["n_nationkey"],
                  payload=["n_name"]))
    orders = (_t(catalog, "orders")
              .filter(col("o_orderdate").between(
                  _D("1994-01-01"), lit(_D("1995-01-01").value - 1)))
              .join(_t(catalog, "customer"), ["o_custkey"], ["c_custkey"],
                    payload=["c_nationkey"]))
    return (
        _t(catalog, "lineitem")
        .join(orders, ["l_orderkey"], ["o_orderkey"], payload=["c_nationkey"])
        .join(supp, ["l_suppkey"], ["s_suppkey"],
              payload=["s_nationkey", "n_name"])
        .filter(col("c_nationkey") == col("s_nationkey"))
        .project("n_name",
                 rev=col("l_extendedprice") * (lit(1.0) - col("l_discount")))
        .group_by("n_name")
        .agg(revenue=("sum", "rev"))
        .order_by("revenue", descending=[True])
        .to_plan())


def q6(catalog) -> P.PlanNode:
    return (
        _t(catalog, "lineitem")
        .filter(col("l_shipdate").between(_D("1994-01-01"),
                                          lit(_D("1995-01-01").value - 1))
                & col("l_discount").between(0.05, 0.07)
                & (col("l_quantity") < 24.0))
        .project(v=col("l_extendedprice") * col("l_discount"))
        .agg(revenue=("sum", "v"))
        .to_plan())


def _q7_nations():
    return _nation("FRANCE"), _nation("GERMANY")


def q7(catalog) -> P.PlanNode:
    fr, de = _q7_nations()
    npair = P.Filter(P.TableScan("nation"),
                     col("n_nationkey").isin([fr, de]))
    supp = P.Join(probe=P.TableScan("supplier"),
                  build=npair, probe_keys=["s_nationkey"],
                  build_keys=["n_nationkey"], build_payload=["n_name"])
    cust = P.Join(probe=P.TableScan("customer"),
                  build=npair, probe_keys=["c_nationkey"],
                  build_keys=["n_nationkey"], build_payload=["n_name"])
    cust = P.Project(cust, [("c_custkey", col("c_custkey")),
                            ("cust_nation", col("n_name"))])
    orders = P.Join(probe=P.TableScan("orders"),
                    build=cust, probe_keys=["o_custkey"],
                    build_keys=["c_custkey"], build_payload=["cust_nation"])
    li = P.Filter(P.TableScan("lineitem"),
                  col("l_shipdate").between(_D("1995-01-01"), _D("1996-12-31")))
    li_s = P.Join(probe=li, build=supp, probe_keys=["l_suppkey"],
                  build_keys=["s_suppkey"], build_payload=["n_name"])
    li_s = P.Project(li_s, [("l_orderkey", col("l_orderkey")),
                            ("supp_nation", col("n_name")),
                            ("l_shipdate", col("l_shipdate")),
                            ("l_extendedprice", col("l_extendedprice")),
                            ("l_discount", col("l_discount"))])
    both = P.Join(probe=li_s, build=orders, probe_keys=["l_orderkey"],
                  build_keys=["o_orderkey"], build_payload=["cust_nation"])
    matched = P.Filter(
        both,
        ((col("supp_nation") == lit(fr)) & (col("cust_nation") == lit(de)))
        | ((col("supp_nation") == lit(de)) & (col("cust_nation") == lit(fr))))
    return P.OrderBy(
        P.Aggregation(
            P.Project(matched, [("supp_nation", col("supp_nation")),
                                ("cust_nation", col("cust_nation")),
                                ("l_year", year(col("l_shipdate"))),
                                ("volume", col("l_extendedprice")
                                 * (lit(1.0) - col("l_discount")))]),
            group_keys=["supp_nation", "cust_nation", "l_year"],
            aggs=[("revenue", "sum", "volume")]),
        keys=["supp_nation", "cust_nation", "l_year"])


def q8(catalog) -> P.PlanNode:
    target_type = _dict_code(S.PART["p_type"], "ECONOMY ANODIZED STEEL")
    brazil = _nation("BRAZIL")
    part_f = P.Filter(P.TableScan("part"), col("p_type") == lit(target_type))
    am_cust = P.Join(
        probe=P.TableScan("customer"),
        build=P.Join(probe=P.TableScan("nation"),
                     build=P.Filter(P.TableScan("region"),
                                    col("r_name") == lit(_region("AMERICA"))),
                     probe_keys=["n_regionkey"], build_keys=["r_regionkey"],
                     join_type="left_semi"),
        probe_keys=["c_nationkey"], build_keys=["n_nationkey"],
        join_type="left_semi")
    orders = P.Join(
        probe=P.Filter(P.TableScan("orders"),
                       col("o_orderdate").between(_D("1995-01-01"),
                                                  _D("1996-12-31"))),
        build=am_cust, probe_keys=["o_custkey"], build_keys=["c_custkey"],
        join_type="left_semi")
    li = P.Join(
        probe=P.TableScan("lineitem"),
        build=part_f, probe_keys=["l_partkey"], build_keys=["p_partkey"],
        join_type="left_semi")
    li_o = P.Join(probe=li, build=orders, probe_keys=["l_orderkey"],
                  build_keys=["o_orderkey"], build_payload=["o_orderdate"])
    li_os = P.Join(probe=li_o,
                   build=P.TableScan("supplier"),
                   probe_keys=["l_suppkey"], build_keys=["s_suppkey"],
                   build_payload=["s_nationkey"])
    vols = P.Project(li_os, [
        ("o_year", year(col("o_orderdate"))),
        ("volume", col("l_extendedprice") * (lit(1.0) - col("l_discount"))),
        ("is_brazil", (col("s_nationkey") == lit(brazil)))])
    vols = P.Project(vols, [
        ("o_year", col("o_year")),
        ("volume", col("volume")),
        ("brazil_volume", col("volume") * col("is_brazil"))])
    agg = P.Aggregation(vols, ["o_year"],
                        [("nat", "sum", "brazil_volume"),
                         ("total", "sum", "volume")])
    return P.OrderBy(
        P.Project(agg, [("o_year", col("o_year")),
                        ("mkt_share", col("nat") / col("total"))]),
        keys=["o_year"])


def q9(catalog) -> P.PlanNode:
    part_f = P.Filter(P.TableScan("part"), col("p_name").contains("green"))
    li = P.Join(probe=P.TableScan("lineitem"),
                build=part_f, probe_keys=["l_partkey"],
                build_keys=["p_partkey"], join_type="left_semi")
    li_s = P.Join(probe=li,
                  build=P.TableScan("supplier"),
                  probe_keys=["l_suppkey"], build_keys=["s_suppkey"],
                  build_payload=["s_nationkey"])
    # hashed composite key: collision headroom even without catalog key
    # stats (the optimizer re-derives this when stats are declared)
    li_ps = P.Join(probe=li_s,
                   build=P.TableScan("partsupp"),
                   probe_keys=["l_partkey", "l_suppkey"],
                   build_keys=["ps_partkey", "ps_suppkey"],
                   build_payload=["ps_supplycost"],
                   max_matches=4)
    li_o = P.Join(probe=li_ps,
                  build=P.TableScan("orders"),
                  probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
                  build_payload=["o_orderdate"])
    li_n = P.Join(probe=li_o, build=P.TableScan("nation"),
                  probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
                  build_payload=["n_name"])
    amount = (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
              - col("ps_supplycost") * col("l_quantity"))
    return P.OrderBy(
        P.Aggregation(
            P.Project(li_n, [("nation", col("n_name")),
                             ("o_year", year(col("o_orderdate"))),
                             ("amount", amount)]),
            group_keys=["nation", "o_year"],
            aggs=[("sum_profit", "sum", "amount")]),
        keys=["nation", "o_year"], descending=[False, True])


def q10(catalog) -> P.PlanNode:
    orders = (_t(catalog, "orders")
              .filter(col("o_orderdate").between(
                  _D("1993-10-01"), lit(_D("1994-01-01").value - 1))))
    rev = (_t(catalog, "lineitem")
           .filter(col("l_returnflag") == lit(_dict_code(
               S.LINEITEM["l_returnflag"], "R")))
           .join(orders, ["l_orderkey"], ["o_orderkey"],
                 payload=["o_custkey"])
           .project("o_custkey",
                    rev=col("l_extendedprice") * (lit(1.0) - col("l_discount")))
           .group_by("o_custkey")
           .agg(revenue=("sum", "rev")))
    return (
        _t(catalog, "customer")
        .join(rev, ["c_custkey"], ["o_custkey"], payload=["revenue"])
        .join(_t(catalog, "nation"), ["c_nationkey"], ["n_nationkey"],
              payload=["n_name"])
        .project("c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                 "c_address", "c_phone", "c_comment")
        .order_by("revenue", descending=[True], limit=20)
        .to_plan())


def q11(catalog, fraction: float = None) -> P.PlanNode:
    if fraction is None:
        n_supp = catalog.get("supplier").num_rows()
        fraction = 0.0001 / max(n_supp / 10000.0, 1e-9)
    de_supp = P.Join(
        probe=P.TableScan("supplier"),
        build=P.Filter(P.TableScan("nation"),
                       col("n_name") == lit(_nation("GERMANY"))),
        probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        join_type="left_semi")
    ps = P.Join(probe=P.TableScan("partsupp"), build=de_supp,
                probe_keys=["ps_suppkey"], build_keys=["s_suppkey"],
                join_type="left_semi")
    ps = P.Project(ps, [("ps_partkey", col("ps_partkey")),
                        ("value", col("ps_supplycost") * col("ps_availqty"))])
    per_part = P.Aggregation(ps, ["ps_partkey"], [("value", "sum", "value")])
    total = P.Aggregation(P.Project(per_part, [("tval", col("value"))]),
                          [], [("total", "sum", "tval")])
    filtered = P.Filter(
        P.ScalarBroadcast(per_part, total, ["total"]),
        col("value") > col("total") * lit(float(fraction)))
    return P.OrderBy(P.Project(filtered, [("ps_partkey", col("ps_partkey")),
                                          ("value", col("value"))]),
                     keys=["value"], descending=[True])


def q12(catalog) -> P.PlanNode:
    mail = _dict_code(S.LINEITEM["l_shipmode"], "MAIL")
    ship = _dict_code(S.LINEITEM["l_shipmode"], "SHIP")
    urgent = _dict_code(S.ORDERS["o_orderpriority"], "1-URGENT")
    high = _dict_code(S.ORDERS["o_orderpriority"], "2-HIGH")
    li = P.Filter(
        P.TableScan("lineitem"),
        col("l_shipmode").isin([mail, ship])
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & col("l_receiptdate").between(_D("1994-01-01"),
                                       lit(_D("1995-01-01").value - 1)))
    li_o = P.Join(probe=li,
                  build=P.TableScan("orders"),
                  probe_keys=["l_orderkey"], build_keys=["o_orderkey"],
                  build_payload=["o_orderpriority"])
    flagged = P.Project(li_o, [
        ("l_shipmode", col("l_shipmode")),
        ("is_high", (col("o_orderpriority") == lit(urgent))
         | (col("o_orderpriority") == lit(high)))])
    flagged = P.Project(flagged, [
        ("l_shipmode", col("l_shipmode")),
        ("high", col("is_high") * lit(1)),
        ("low", (~col("is_high")) * lit(1))])
    return P.OrderBy(
        P.Aggregation(flagged, ["l_shipmode"],
                      [("high_line_count", "sum", "high"),
                       ("low_line_count", "sum", "low")]),
        keys=["l_shipmode"])


def q13(catalog) -> P.PlanNode:
    orders = P.Filter(P.TableScan("orders"),
                      ~col("o_comment").contains("special", "requests"))
    per_cust = P.Aggregation(orders, ["o_custkey"],
                             [("c_count", "count", None)])
    cust = P.Join(probe=P.TableScan("customer"), build=per_cust,
                  probe_keys=["c_custkey"],
                  build_keys=["o_custkey"], build_payload=["c_count"],
                  join_type="left_outer")
    cust = P.Project(cust, [("c_count", col("c_count") * col("__matched"))])
    return P.OrderBy(
        P.Aggregation(cust, ["c_count"], [("custdist", "count", None)]),
        keys=["custdist", "c_count"], descending=[True, True])


def q14(catalog) -> P.PlanNode:
    promo_codes = [i for i, t in enumerate(S.TYPES) if t.startswith("PROMO")]
    rev = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (
        _t(catalog, "lineitem")
        .filter(col("l_shipdate").between(_D("1995-09-01"),
                                          lit(_D("1995-10-01").value - 1)))
        .join(_t(catalog, "part"), ["l_partkey"], ["p_partkey"],
              payload=["p_type"])
        .project(rev=rev, is_promo=col("p_type").isin(promo_codes))
        .project("rev", promo_rev=col("rev") * col("is_promo"))
        .agg(promo=("sum", "promo_rev"), total=("sum", "rev"))
        .project(promo_revenue=lit(100.0) * col("promo") / col("total"))
        .to_plan())


def q15(catalog) -> P.PlanNode:
    li = P.Filter(P.TableScan("lineitem"),
                  col("l_shipdate").between(_D("1996-01-01"),
                                            lit(_D("1996-04-01").value - 1)))
    rev = P.Aggregation(
        P.Project(li, [("l_suppkey", col("l_suppkey")),
                       ("rev", col("l_extendedprice")
                        * (lit(1.0) - col("l_discount")))]),
        group_keys=["l_suppkey"], aggs=[("total_revenue", "sum", "rev")])
    maxrev = P.Aggregation(P.Project(rev, [("r", col("total_revenue"))]),
                           [], [("max_rev", "max", "r")])
    best = P.Filter(P.ScalarBroadcast(rev, maxrev, ["max_rev"]),
                    col("total_revenue") == col("max_rev"))
    supp = P.Join(probe=P.TableScan("supplier"),
                  build=best, probe_keys=["s_suppkey"],
                  build_keys=["l_suppkey"], build_payload=["total_revenue"])
    return P.OrderBy(
        P.Project(supp, [("s_suppkey", col("s_suppkey")),
                         ("s_name", col("s_name")),
                         ("s_address", col("s_address")),
                         ("s_phone", col("s_phone")),
                         ("total_revenue", col("total_revenue"))]),
        keys=["s_suppkey"])


def q16(catalog) -> P.PlanNode:
    brand45 = _dict_code(S.PART["p_brand"], "Brand#45")
    med_pol = [i for i, t in enumerate(S.TYPES)
               if t.startswith("MEDIUM POLISHED")]
    sizes = [49, 14, 23, 45, 19, 3, 36, 9]
    part_f = P.Filter(
        P.TableScan("part"),
        (col("p_brand") != lit(brand45))
        & (~col("p_type").isin(med_pol))
        & col("p_size").isin(sizes))
    ps = P.Join(probe=P.TableScan("partsupp"),
                build=part_f, probe_keys=["ps_partkey"],
                build_keys=["p_partkey"],
                build_payload=["p_brand", "p_type", "p_size"])
    bad_supp = P.Filter(P.TableScan("supplier"),
                        col("s_comment").contains("Customer", "Complaints"))
    ps = P.Join(probe=ps, build=bad_supp, probe_keys=["ps_suppkey"],
                build_keys=["s_suppkey"], join_type="left_anti")
    dedup = P.Distinct(ps, ["p_brand", "p_type", "p_size", "ps_suppkey"])
    return P.OrderBy(
        P.Aggregation(dedup, ["p_brand", "p_type", "p_size"],
                      [("supplier_cnt", "count", None)]),
        keys=["supplier_cnt", "p_brand", "p_type", "p_size"],
        descending=[True, False, False, False])


def q17(catalog) -> P.PlanNode:
    brand = _dict_code(S.PART["p_brand"], "Brand#23")
    box = _dict_code(S.PART["p_container"], "MED BOX")
    part_f = P.Filter(P.TableScan("part"),
                      (col("p_brand") == lit(brand))
                      & (col("p_container") == lit(box)))
    li = P.Join(probe=P.TableScan("lineitem"),
                build=part_f, probe_keys=["l_partkey"],
                build_keys=["p_partkey"], join_type="left_semi")
    avg_q = P.Aggregation(li, ["l_partkey"], [("avg_qty", "avg", "l_quantity")])
    joined = P.Join(probe=li, build=avg_q, probe_keys=["l_partkey"],
                    build_keys=["l_partkey"], build_payload=["avg_qty"])
    small = P.Filter(joined, col("l_quantity") < lit(0.2) * col("avg_qty"))
    agg = P.Aggregation(small, [], [("s", "sum", "l_extendedprice")])
    return P.Project(agg, [("avg_yearly", col("s") / lit(7.0))])


def q18(catalog) -> P.PlanNode:
    per_order = P.Aggregation(
        P.TableScan("lineitem"),
        ["l_orderkey"], [("sum_qty", "sum", "l_quantity")])
    big = P.Filter(per_order, col("sum_qty") > lit(300.0))
    orders = P.Join(probe=P.TableScan("orders"),
                    build=big, probe_keys=["o_orderkey"],
                    build_keys=["l_orderkey"], build_payload=["sum_qty"])
    cust = P.Join(probe=orders,
                  build=P.TableScan("customer"),
                  probe_keys=["o_custkey"], build_keys=["c_custkey"],
                  build_payload=["c_name"])
    return P.OrderBy(
        P.Project(cust, [("o_orderkey", col("o_orderkey")),
                         ("o_custkey", col("o_custkey")),
                         ("o_orderdate", col("o_orderdate")),
                         ("o_totalprice", col("o_totalprice")),
                         ("sum_qty", col("sum_qty")),
                         ("c_name", col("c_name"))]),
        keys=["o_totalprice", "o_orderdate"],
        descending=[True, False], limit=100)


def q19(catalog) -> P.PlanNode:
    sm = S.LINEITEM["l_shipmode"]
    air, reg_air = _dict_code(sm, "AIR"), _dict_code(sm, "REG AIR")
    deliver = _dict_code(S.LINEITEM["l_shipinstruct"], "DELIVER IN PERSON")
    b12 = _dict_code(S.PART["p_brand"], "Brand#12")
    b23 = _dict_code(S.PART["p_brand"], "Brand#23")
    b34 = _dict_code(S.PART["p_brand"], "Brand#34")
    cont = S.PART["p_container"]
    sm_containers = [_dict_code(cont, c) for c in
                     ("SM CASE", "SM BOX", "SM PACK", "SM PKG")]
    med_containers = [_dict_code(cont, c) for c in
                      ("MED BAG", "MED BOX", "MED PKG", "MED PACK")]
    lg_containers = [_dict_code(cont, c) for c in
                     ("LG CASE", "LG BOX", "LG PACK", "LG PKG")]
    li = P.Filter(P.TableScan("lineitem"),
                  col("l_shipmode").isin([air, reg_air])
                  & (col("l_shipinstruct") == lit(deliver)))
    li_p = P.Join(probe=li,
                  build=P.TableScan("part"),
                  probe_keys=["l_partkey"], build_keys=["p_partkey"],
                  build_payload=["p_brand", "p_size", "p_container"])
    bracket1 = ((col("p_brand") == lit(b12))
                & col("p_container").isin(sm_containers)
                & col("l_quantity").between(1.0, 11.0)
                & col("p_size").between(1, 5))
    bracket2 = ((col("p_brand") == lit(b23))
                & col("p_container").isin(med_containers)
                & col("l_quantity").between(10.0, 20.0)
                & col("p_size").between(1, 10))
    bracket3 = ((col("p_brand") == lit(b34))
                & col("p_container").isin(lg_containers)
                & col("l_quantity").between(20.0, 30.0)
                & col("p_size").between(1, 15))
    matched = P.Filter(li_p, bracket1 | bracket2 | bracket3)
    return P.Aggregation(
        P.Project(matched, [("rev", col("l_extendedprice")
                             * (lit(1.0) - col("l_discount")))]),
        group_keys=[], aggs=[("revenue", "sum", "rev")])


def q20(catalog) -> P.PlanNode:
    forest = P.Filter(P.TableScan("part"), col("p_name").startswith("forest"))
    qty94 = P.Aggregation(
        P.Filter(P.TableScan("lineitem"),
                 col("l_shipdate").between(_D("1994-01-01"),
                                           lit(_D("1995-01-01").value - 1))),
        ["l_partkey", "l_suppkey"], [("qty", "sum", "l_quantity")])
    ps = P.Join(probe=P.TableScan("partsupp"),
                build=forest, probe_keys=["ps_partkey"],
                build_keys=["p_partkey"], join_type="left_semi")
    # hashed composite key: collision headroom even without catalog key stats
    ps_q = P.Join(probe=ps, build=qty94,
                  probe_keys=["ps_partkey", "ps_suppkey"],
                  build_keys=["l_partkey", "l_suppkey"],
                  build_payload=["qty"],
                  max_matches=4)
    excess = P.Filter(ps_q, col("ps_availqty") > lit(0.5) * col("qty"))
    supp_keys = P.Distinct(excess, ["ps_suppkey"])
    ca_supp = P.Join(
        probe=P.Join(probe=P.TableScan("supplier"),
                     build=supp_keys, probe_keys=["s_suppkey"],
                     build_keys=["ps_suppkey"], join_type="left_semi"),
        build=P.Filter(P.TableScan("nation"),
                       col("n_name") == lit(_nation("CANADA"))),
        probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        join_type="left_semi")
    return P.OrderBy(P.Project(ca_supp, [("s_name", col("s_name")),
                                         ("s_address", col("s_address"))]),
                     keys=["s_name"])


def q21(catalog) -> P.PlanNode:
    li = P.TableScan("lineitem", columns=["l_orderkey", "l_suppkey",
                                          "l_commitdate", "l_receiptdate"])
    all_supp = P.Aggregation(
        P.Distinct(li, ["l_orderkey", "l_suppkey"]),
        ["l_orderkey"], [("nsupp", "count", None)])
    late = P.Filter(li, col("l_receiptdate") > col("l_commitdate"))
    late_supp = P.Aggregation(
        P.Distinct(late, ["l_orderkey", "l_suppkey"]),
        ["l_orderkey"], [("nlate", "count", None)])
    f_orders = P.Filter(P.TableScan("orders"),
                        col("o_orderstatus") == lit(_dict_code(
                            S.ORDERS["o_orderstatus"], "F")))
    l1 = P.Join(probe=late, build=f_orders, probe_keys=["l_orderkey"],
                build_keys=["o_orderkey"], join_type="left_semi")
    sa_supp = P.Join(
        probe=P.TableScan("supplier"),
        build=P.Filter(P.TableScan("nation"),
                       col("n_name") == lit(_nation("SAUDI ARABIA"))),
        probe_keys=["s_nationkey"], build_keys=["n_nationkey"],
        join_type="left_semi")
    l1_s = P.Join(probe=l1, build=sa_supp, probe_keys=["l_suppkey"],
                  build_keys=["s_suppkey"], build_payload=["s_name"])
    l1_c = P.Join(probe=l1_s, build=all_supp, probe_keys=["l_orderkey"],
                  build_keys=["l_orderkey"], build_payload=["nsupp"])
    l1_cc = P.Join(probe=l1_c, build=late_supp, probe_keys=["l_orderkey"],
                   build_keys=["l_orderkey"], build_payload=["nlate"])
    waiting = P.Filter(l1_cc, (col("nsupp") >= lit(2)) & (col("nlate") == lit(1)))
    return P.OrderBy(
        P.Aggregation(waiting, ["s_name"], [("numwait", "count", None)]),
        keys=["numwait", "s_name"], descending=[True, False], limit=100)


def q22(catalog) -> P.PlanNode:
    codes = [13, 31, 23, 29, 30, 18, 17]
    cust = P.Project(P.TableScan("customer"),
                     [("c_custkey", col("c_custkey")),
                      ("cntrycode", prefix_code(col("c_phone"), 2)),
                      ("c_acctbal", col("c_acctbal"))])
    in_codes = P.Filter(cust, col("cntrycode").isin(codes))
    positive = P.Filter(in_codes, col("c_acctbal") > lit(0.0))
    avg_bal = P.Aggregation(positive, [], [("avg_bal", "avg", "c_acctbal")])
    rich = P.Filter(P.ScalarBroadcast(in_codes, avg_bal, ["avg_bal"]),
                    col("c_acctbal") > col("avg_bal"))
    no_orders = P.Join(probe=rich,
                       build=P.TableScan("orders"),
                       probe_keys=["c_custkey"], build_keys=["o_custkey"],
                       join_type="left_anti")
    return P.OrderBy(
        P.Aggregation(no_orders, ["cntrycode"],
                      [("numcust", "count", None),
                       ("totacctbal", "sum", "c_acctbal")]),
        keys=["cntrycode"])


QUERIES: Dict[int, Callable] = {
    1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9, 10: q10,
    11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18,
    19: q19, 20: q20, 21: q21, 22: q22,
}


def build_query(qnum: int, catalog, optimized: bool = True,
                num_workers: int = 1) -> P.PlanNode:
    """Logical plan for query ``qnum``, run through the optimizer pipeline
    (pass ``optimized=False`` for the raw tree).

    With ``num_workers > 1`` the optimizer also places physical exchanges:
    the returned tree is a distributed fragment plan whose
    ``Repartition``/``Broadcast`` nodes target that worker count (execute it
    on a session with the same ``num_workers``).
    """
    plan = QUERIES[qnum](catalog)
    if not optimized:
        return plan
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_workers=num_workers)
    return optimize(plan, catalog, config=cfg)
