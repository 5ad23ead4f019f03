"""TPC-H queries as SQL text, for the ``core.sql`` frontend (the port's
copy of ``repro.tpch.sqltext``; the texts are character for character the
reference's).

Twenty of the 22 spec queries expressed in the SQL subset the frontend
lowers (see ``core/sql.py``); output column names match the reference's
``tpch/oracle.py``, so SQL-path executions are checked the same way as the
hand-built plans. Two queries need constructs
the engine has no operator for and are intentionally absent, documented in
``UNSUPPORTED``: Q13 (LEFT OUTER JOIN aggregation) and Q21 (correlated
EXISTS with a non-equi predicate).

Three queries are restated in equivalent SQL to stay inside the engine's
static-shape operator set — the results are identical:

* Q10/Q18 group through a derived table on the integer key alone instead
  of the spec's "drag every output column into GROUP BY" form (the engine
  groups on int-family keys; ``c_acctbal``/``o_totalprice`` are floats);
* Q11's threshold subexpression ``0.0001 / SF`` is a literal computed from
  the catalog row counts, so the text depends on the loaded scale factor.

``sql_text(qnum, catalog)`` returns the text; the same string runs on
DuckDB unmodified (``tests/sql_oracle.py`` does exactly that).
"""

from __future__ import annotations

_Q1 = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

_Q2 = """
SELECT s_acctbal, s_name, n_name, p_partkey
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
  AND p_size = 15 AND p_type LIKE '%BRASS'
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'EUROPE'
  AND ps_supplycost = (
      SELECT min(ps_supplycost)
      FROM partsupp, supplier, nation, region
      WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
        AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
        AND r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100
"""

_Q3 = """
SELECT l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING'
  AND c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
"""

_Q4 = """
SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= DATE '1993-07-01'
  AND o_orderdate < DATE '1993-07-01' + INTERVAL '3' MONTH
  AND EXISTS (
      SELECT * FROM lineitem
      WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""

_Q5 = """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'ASIA'
  AND o_orderdate >= DATE '1994-01-01'
  AND o_orderdate < DATE '1994-01-01' + INTERVAL '1' YEAR
GROUP BY n_name
ORDER BY revenue DESC
"""

_Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01'
  AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""

_Q7 = """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
             EXTRACT(YEAR FROM l_shipdate) AS l_year,
             l_extendedprice * (1 - l_discount) AS volume
      FROM supplier, lineitem, orders, customer, nation n1, nation n2
      WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
        AND c_custkey = o_custkey
        AND s_nationkey = n1.n_nationkey
        AND c_nationkey = n2.n_nationkey
        AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
             OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
        AND l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
     ) shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year
"""

_Q8 = """
SELECT o_year,
       sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0.0 END)
         / sum(volume) AS mkt_share
FROM (SELECT EXTRACT(YEAR FROM o_orderdate) AS o_year,
             l_extendedprice * (1 - l_discount) AS volume,
             n2.n_name AS nation
      FROM part, supplier, lineitem, orders, customer,
           nation n1, nation n2, region
      WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
        AND l_orderkey = o_orderkey AND o_custkey = c_custkey
        AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey
        AND r_name = 'AMERICA' AND s_nationkey = n2.n_nationkey
        AND o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
        AND p_type = 'ECONOMY ANODIZED STEEL'
     ) all_nations
GROUP BY o_year
ORDER BY o_year
"""

_Q9 = """
SELECT nation, o_year, sum(amount) AS sum_profit
FROM (SELECT n_name AS nation,
             EXTRACT(YEAR FROM o_orderdate) AS o_year,
             l_extendedprice * (1 - l_discount)
               - ps_supplycost * l_quantity AS amount
      FROM part, supplier, lineitem, partsupp, orders, nation
      WHERE s_suppkey = l_suppkey
        AND ps_suppkey = l_suppkey AND ps_partkey = l_partkey
        AND p_partkey = l_partkey AND o_orderkey = l_orderkey
        AND s_nationkey = n_nationkey
        AND p_name LIKE '%green%'
     ) profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC
"""

_Q10 = """
SELECT c_custkey, revenue, c_acctbal
FROM customer,
     (SELECT o_custkey,
             sum(l_extendedprice * (1 - l_discount)) AS revenue
      FROM orders, lineitem
      WHERE l_orderkey = o_orderkey
        AND o_orderdate >= DATE '1993-10-01'
        AND o_orderdate < DATE '1993-10-01' + INTERVAL '3' MONTH
        AND l_returnflag = 'R'
      GROUP BY o_custkey) rev
WHERE c_custkey = o_custkey
ORDER BY revenue DESC
LIMIT 20
"""

_Q11 = """
SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
  AND n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) > (
    SELECT sum(ps_supplycost * ps_availqty) * {fraction:.12g}
    FROM partsupp, supplier, nation
    WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
      AND n_name = 'GERMANY')
ORDER BY value DESC
"""

_Q12 = """
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT'
                  OR o_orderpriority = '2-HIGH'
                THEN 1 ELSE 0 END) AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT'
                 AND o_orderpriority <> '2-HIGH'
                THEN 1 ELSE 0 END) AS low_line_count
FROM orders, lineitem
WHERE o_orderkey = l_orderkey
  AND l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate
  AND l_shipdate < l_commitdate
  AND l_receiptdate >= DATE '1994-01-01'
  AND l_receiptdate < DATE '1994-01-01' + INTERVAL '1' YEAR
GROUP BY l_shipmode
ORDER BY l_shipmode
"""

_Q14 = """
SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
                         THEN l_extendedprice * (1 - l_discount)
                         ELSE 0.0 END)
       / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem, part
WHERE l_partkey = p_partkey
  AND l_shipdate >= DATE '1995-09-01'
  AND l_shipdate < DATE '1995-09-01' + INTERVAL '1' MONTH
"""

_Q15 = """
WITH revenue AS (
    SELECT l_suppkey AS supplier_no,
           sum(l_extendedprice * (1 - l_discount)) AS total_revenue
    FROM lineitem
    WHERE l_shipdate >= DATE '1996-01-01'
      AND l_shipdate < DATE '1996-01-01' + INTERVAL '3' MONTH
    GROUP BY l_suppkey)
SELECT s_suppkey, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey
"""

_Q16 = """
SELECT p_brand, p_type, p_size,
       count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp, part
WHERE p_partkey = ps_partkey
  AND p_brand <> 'Brand#45'
  AND p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (
      SELECT s_suppkey FROM supplier
      WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
"""

_Q17 = """
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem, part
WHERE p_partkey = l_partkey
  AND p_brand = 'Brand#23' AND p_container = 'MED BOX'
  AND l_quantity < (SELECT 0.2 * avg(l_quantity)
                    FROM lineitem l2
                    WHERE l2.l_partkey = p_partkey)
"""

_Q18 = """
SELECT c_custkey, o_orderkey, o_orderdate, o_totalprice, sum_qty
FROM customer, orders,
     (SELECT l_orderkey, sum(l_quantity) AS sum_qty
      FROM lineitem GROUP BY l_orderkey) lq
WHERE sum_qty > 300
  AND c_custkey = o_custkey AND o_orderkey = l_orderkey
ORDER BY o_totalprice DESC, o_orderdate
LIMIT 100
"""

_Q19 = """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem JOIN part ON p_partkey = l_partkey
WHERE ((p_brand = 'Brand#12'
        AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        AND l_quantity >= 1 AND l_quantity <= 11
        AND p_size BETWEEN 1 AND 5)
    OR (p_brand = 'Brand#23'
        AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        AND l_quantity >= 10 AND l_quantity <= 20
        AND p_size BETWEEN 1 AND 10)
    OR (p_brand = 'Brand#34'
        AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        AND l_quantity >= 20 AND l_quantity <= 30
        AND p_size BETWEEN 1 AND 15))
  AND l_shipmode IN ('AIR', 'REG AIR')
  AND l_shipinstruct = 'DELIVER IN PERSON'
"""

_Q20 = """
SELECT s_name, s_suppkey
FROM supplier, nation
WHERE s_suppkey IN (
      SELECT ps_suppkey
      FROM partsupp, part
      WHERE ps_partkey = p_partkey
        AND p_name LIKE 'forest%'
        AND ps_availqty > (
            SELECT 0.5 * sum(l_quantity)
            FROM lineitem
            WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
              AND l_shipdate >= DATE '1994-01-01'
              AND l_shipdate < DATE '1994-01-01' + INTERVAL '1' YEAR))
  AND s_nationkey = n_nationkey AND n_name = 'CANADA'
ORDER BY s_name
"""

_Q22 = """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (SELECT SUBSTRING(c_phone, 1, 2) AS cntrycode, c_acctbal, c_custkey
      FROM customer
      WHERE SUBSTRING(c_phone, 1, 2) IN
              ('13', '31', '23', '29', '30', '18', '17')
        AND c_acctbal > (
            SELECT avg(c_acctbal) FROM customer
            WHERE c_acctbal > 0.00
              AND SUBSTRING(c_phone, 1, 2) IN
                    ('13', '31', '23', '29', '30', '18', '17'))
        AND NOT EXISTS (
            SELECT * FROM orders WHERE o_custkey = c_custkey)
     ) custsale
GROUP BY cntrycode
ORDER BY cntrycode
"""

_TEXTS = {1: _Q1, 2: _Q2, 3: _Q3, 4: _Q4, 5: _Q5, 6: _Q6, 7: _Q7, 8: _Q8,
          9: _Q9, 10: _Q10, 11: _Q11, 12: _Q12, 14: _Q14, 15: _Q15,
          16: _Q16, 17: _Q17, 18: _Q18, 19: _Q19, 20: _Q20, 22: _Q22}

SUPPORTED = tuple(sorted(_TEXTS))

#: qnum -> the construct that keeps it off the SQL path (the engine has no
#: operator for it; ``core.sql`` raises SqlUnsupportedError for both)
UNSUPPORTED = {
    13: "LEFT OUTER JOIN (count-orders-per-customer including zeros)",
    21: "correlated EXISTS with a non-equi (<>) predicate",
}


def sql_text(qnum: int, catalog=None) -> str:
    """SQL text for TPC-H query ``qnum``.

    Q11's HAVING threshold is scale-factor dependent (``0.0001 / SF``); the
    spec derives it from the supplier count, so Q11 needs ``catalog``.
    """
    if qnum not in _TEXTS:
        raise KeyError(
            f"q{qnum} has no SQL-path port: "
            f"{UNSUPPORTED.get(qnum, 'unknown query')}")
    text = _TEXTS[qnum]
    if qnum == 11:
        if catalog is None:
            raise ValueError("sql_text(11) needs the catalog (the HAVING "
                             "fraction depends on the scale factor)")
        n_supp = catalog.get("supplier").num_rows()
        fraction = 0.0001 / max(n_supp / 10000.0, 1e-9)
        text = text.replace("{fraction:.12g}", f"{fraction:.12g}")
        return text.strip()
    return text.strip()
