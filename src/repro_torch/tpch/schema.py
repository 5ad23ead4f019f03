"""TPC-H table schemas (the port's copy of ``repro.tpch.schema``).

Strings: low-cardinality columns are dictionary-encoded (sorted dictionaries
so code order == lexicographic order); pattern-matched columns (names,
comments) are fixed-width byte matrices; dates are date32.
"""

from __future__ import annotations

from ..core import dtypes as dt

# -- sorted dictionaries (order matters: ORDER BY on codes) -----------------

REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")

NATIONS = (
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "CHINA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "ROMANIA",
    "RUSSIA", "SAUDI ARABIA", "UNITED KINGDOM", "UNITED STATES", "VIETNAM",
)
# nation -> region mapping (per TPC-H spec)
NATION_REGION = (0, 1, 1, 1, 2, 0, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 3,
                 3, 4, 3, 1, 2)

SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
SHIPINSTRUCT = ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN")
RETURNFLAGS = ("A", "N", "R")
LINESTATUS = ("F", "O")
ORDERSTATUS = ("F", "O", "P")
MFGRS = tuple(f"Manufacturer#{i}" for i in range(1, 6))
BRANDS = tuple(sorted(f"Brand#{m}{b}" for m in range(1, 6) for b in range(1, 6)))

_TYPE_1 = ("ECONOMY", "LARGE", "MEDIUM", "PROMO", "SMALL", "STANDARD")
_TYPE_2 = ("ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED")
_TYPE_3 = ("BRASS", "COPPER", "NICKEL", "STEEL", "TIN")
TYPES = tuple(sorted(f"{a} {b} {c}" for a in _TYPE_1 for b in _TYPE_2
                     for c in _TYPE_3))

_CONT_1 = ("JUMBO", "LG", "MED", "SM", "WRAP")
_CONT_2 = ("BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG")
CONTAINERS = tuple(sorted(f"{a} {b}" for a in _CONT_1 for b in _CONT_2))

COLORS = ("almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger",
          "drab", "firebrick", "floral", "forest", "frosted", "gainsboro",
          "ghost", "goldenrod", "green", "grey", "honeydew", "hot", "indian",
          "ivory", "khaki", "lace", "lavender", "lawn", "lemon", "light",
          "lime", "linen", "magenta", "maroon", "medium", "metallic")

# -- schemas -----------------------------------------------------------------

REGION = {
    "r_regionkey": dt.INT32,
    "r_name": dt.dict32(REGIONS),
}

NATION = {
    "n_nationkey": dt.INT32,
    "n_name": dt.dict32(NATIONS),
    "n_regionkey": dt.INT32,
}

SUPPLIER = {
    "s_suppkey": dt.INT32,
    "s_name": dt.bytes_(18),
    "s_address": dt.bytes_(16),
    "s_nationkey": dt.INT32,
    "s_phone": dt.bytes_(15),
    "s_acctbal": dt.FLOAT32,
    "s_comment": dt.bytes_(44),
}

CUSTOMER = {
    "c_custkey": dt.INT32,
    "c_name": dt.bytes_(18),
    "c_address": dt.bytes_(16),
    "c_nationkey": dt.INT32,
    "c_phone": dt.bytes_(15),
    "c_acctbal": dt.FLOAT32,
    "c_mktsegment": dt.dict32(SEGMENTS),
    "c_comment": dt.bytes_(24),
}

PART = {
    "p_partkey": dt.INT32,
    "p_name": dt.bytes_(36),
    "p_mfgr": dt.dict32(MFGRS),
    "p_brand": dt.dict32(BRANDS),
    "p_type": dt.dict32(TYPES),
    "p_size": dt.INT32,
    "p_container": dt.dict32(CONTAINERS),
    "p_retailprice": dt.FLOAT32,
}

PARTSUPP = {
    "ps_partkey": dt.INT32,
    "ps_suppkey": dt.INT32,
    "ps_availqty": dt.INT32,
    "ps_supplycost": dt.FLOAT32,
}

ORDERS = {
    "o_orderkey": dt.INT32,
    "o_custkey": dt.INT32,
    "o_orderstatus": dt.dict32(ORDERSTATUS),
    "o_totalprice": dt.FLOAT32,
    "o_orderdate": dt.DATE32,
    "o_orderpriority": dt.dict32(PRIORITIES),
    "o_shippriority": dt.INT32,
    "o_comment": dt.bytes_(44),
}

LINEITEM = {
    "l_orderkey": dt.INT32,
    "l_partkey": dt.INT32,
    "l_suppkey": dt.INT32,
    "l_linenumber": dt.INT32,
    "l_quantity": dt.FLOAT32,
    "l_extendedprice": dt.FLOAT32,
    "l_discount": dt.FLOAT32,
    "l_tax": dt.FLOAT32,
    "l_returnflag": dt.dict32(RETURNFLAGS),
    "l_linestatus": dt.dict32(LINESTATUS),
    "l_shipdate": dt.DATE32,
    "l_commitdate": dt.DATE32,
    "l_receiptdate": dt.DATE32,
    "l_shipmode": dt.dict32(SHIPMODES),
    "l_shipinstruct": dt.dict32(SHIPINSTRUCT),
}

SCHEMAS = {
    "region": REGION,
    "nation": NATION,
    "supplier": SUPPLIER,
    "customer": CUSTOMER,
    "part": PART,
    "partsupp": PARTSUPP,
    "orders": ORDERS,
    "lineitem": LINEITEM,
}

# primary keys (catalog stats for the optimizer's capacity derivation:
# joins against these columns provably match at most one build row)
PRIMARY_KEYS = {
    "region": ("r_regionkey",),
    "nation": ("n_nationkey",),
    "supplier": ("s_suppkey",),
    "customer": ("c_custkey",),
    "part": ("p_partkey",),
    "partsupp": ("ps_partkey", "ps_suppkey"),
    "orders": ("o_orderkey",),
    "lineitem": ("l_orderkey", "l_linenumber"),
}

# base cardinalities at SF=1
BASE_ROWS = {
    "region": 5,
    "nation": 25,
    "supplier": 10_000,
    "customer": 150_000,
    "part": 200_000,
    "partsupp": 800_000,
    "orders": 1_500_000,
    # lineitem: ~4 lines per order on average
}
