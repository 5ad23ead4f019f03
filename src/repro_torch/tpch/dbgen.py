"""dbgen: numpy TPC-H-like data generator (the port's copy of
``repro.tpch.dbgen``).

Deterministic per (sf, seed), and bit-identical to the reference's output
for the same arguments, so both engines scan the same bytes.
``load_catalog`` serves the tables from memory; ``write_dataset`` writes
them in the column-chunk format of §2.2 (one file per column and chunk,
the metadata in the file names; the files are the reference writer's,
byte for byte) and ``storage_catalog`` serves those files::

    data = dbgen.write_dataset("tpch_sf1", sf=1, chunks=8)
    catalog = dbgen.storage_catalog("tpch_sf1")
    out = Session(catalog).execute(queries.build_query(6, catalog))
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..core import dtypes as dt
from ..core.session import Catalog
from ..storage.colchunk import ColumnChunkTable, write_table
from . import schema as S

_D = dt.date_to_i32

START = _D("1992-01-01")             # o_orderdate range per spec
END = _D("1998-08-02")


def _bytes_fmt(prefix: str, keys: np.ndarray, width: int) -> np.ndarray:
    out = np.full((len(keys), width), ord(" "), dtype=np.uint8)
    for i, k in enumerate(keys):
        s = f"{prefix}{k:09d}".encode()[:width]
        out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return out


def _rand_text(rng, n: int, width: int, inject=None, p_inject=0.0) -> np.ndarray:
    """Random lowercase filler text with optional injected pattern."""
    data = rng.integers(ord("a"), ord("z") + 1, size=(n, width)).astype(np.uint8)
    spaces = rng.random((n, width)) < 0.15
    data[spaces] = ord(" ")
    if inject is not None and p_inject > 0:
        hit = rng.random(n) < p_inject
        pat = np.frombuffer(inject.encode(), dtype=np.uint8)
        pos = rng.integers(0, max(width - len(pat), 1), size=n)
        for i in np.where(hit)[0]:
            data[i, pos[i]: pos[i] + len(pat)] = pat
    return data


def _phones(rng, nationkeys: np.ndarray) -> np.ndarray:
    n = len(nationkeys)
    out = np.full((n, 15), ord(" "), dtype=np.uint8)
    rest = rng.integers(0, 10, size=(n, 9))
    for i in range(n):
        code = nationkeys[i] + 10
        s = f"{code:02d}-{rest[i,0]}{rest[i,1]}{rest[i,2]}-{rest[i,3]}" \
            f"{rest[i,4]}{rest[i,5]}-{rest[i,6]}{rest[i,7]}{rest[i,8]}".encode()
        out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return out


def _part_names(rng, n: int) -> np.ndarray:
    """p_name: 5 color words (Q9/Q20 match '%green%' / 'forest%')."""
    out = np.full((n, 36), ord(" "), dtype=np.uint8)
    colors = [c.encode() for c in S.COLORS]
    picks = rng.integers(0, len(colors), size=(n, 5))
    for i in range(n):
        s = b" ".join(colors[j] for j in picks[i])[:36]
        out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return out


def generate(sf: float = 0.01, seed: int = 19940729) -> Dict[str, Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n_supp = max(int(S.BASE_ROWS["supplier"] * sf), 10)
    n_cust = max(int(S.BASE_ROWS["customer"] * sf), 30)
    n_part = max(int(S.BASE_ROWS["part"] * sf), 40)
    n_ord = max(int(S.BASE_ROWS["orders"] * sf), 150)

    region = {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": np.arange(5, dtype=np.int32),
    }
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": np.arange(25, dtype=np.int32),
        "n_regionkey": np.array(S.NATION_REGION, dtype=np.int32),
    }

    s_nation = rng.integers(0, 25, n_supp).astype(np.int32)
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
        "s_name": _bytes_fmt("Supplier#", np.arange(1, n_supp + 1), 18),
        "s_address": _rand_text(rng, n_supp, 16),
        "s_nationkey": s_nation,
        "s_phone": _phones(rng, s_nation),
        "s_acctbal": (rng.random(n_supp) * 10999.99 - 999.99).astype(np.float32),
        "s_comment": _rand_text(rng, n_supp, 44,
                                inject="Customer Complaints", p_inject=0.02),
    }

    c_nation = rng.integers(0, 25, n_cust).astype(np.int32)
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
        "c_name": _bytes_fmt("Customer#", np.arange(1, n_cust + 1), 18),
        "c_address": _rand_text(rng, n_cust, 16),
        "c_nationkey": c_nation,
        "c_phone": _phones(rng, c_nation),
        "c_acctbal": (rng.random(n_cust) * 10999.99 - 999.99).astype(np.float32),
        "c_mktsegment": rng.integers(0, 5, n_cust).astype(np.int32),
        "c_comment": _rand_text(rng, n_cust, 24),
    }

    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
        "p_name": _part_names(rng, n_part),
        "p_mfgr": rng.integers(0, 5, n_part).astype(np.int32),
        "p_brand": rng.integers(0, 25, n_part).astype(np.int32),
        "p_type": rng.integers(0, 150, n_part).astype(np.int32),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": rng.integers(0, 40, n_part).astype(np.int32),
        "p_retailprice": (900 + (np.arange(1, n_part + 1) % 1000) / 10
                          ).astype(np.float32),
    }

    # partsupp: 4 suppliers per part (spec), supplier spread deterministic
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)
    ps_supp = np.zeros(n_part * 4, dtype=np.int32)
    for j in range(4):
        ps_supp[j::4] = ((np.arange(n_part) + j * (n_supp // 4 + 1)) % n_supp) + 1
    partsupp = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, n_part * 4).astype(np.int32),
        "ps_supplycost": (rng.random(n_part * 4) * 999 + 1).astype(np.float32),
    }

    o_orderdate = rng.integers(START, END - 151, n_ord).astype(np.int32)
    orders_key = np.arange(1, n_ord + 1, dtype=np.int32) * 4 - 3  # sparse keys
    n_lines = rng.integers(1, 8, n_ord)
    # per spec, a third of customers never place orders (keeps Q13/Q22 real)
    ordering_custs = np.array([k for k in range(1, n_cust + 1) if k % 3 != 0],
                              dtype=np.int32)
    orders = {
        "o_orderkey": orders_key,
        "o_custkey": rng.choice(ordering_custs, n_ord).astype(np.int32),
        "o_orderstatus": np.zeros(n_ord, dtype=np.int32),   # fixed below
        "o_totalprice": np.zeros(n_ord, dtype=np.float32),  # fixed below
        "o_orderdate": o_orderdate,
        "o_orderpriority": rng.integers(0, 5, n_ord).astype(np.int32),
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_comment": _rand_text(rng, n_ord, 44),
    }
    # Q13 patterns: 'special...requests'
    special = rng.random(n_ord) < 0.05
    pat1 = np.frombuffer(b"special", dtype=np.uint8)
    pat2 = np.frombuffer(b"requests", dtype=np.uint8)
    for i in np.where(special)[0]:
        orders["o_comment"][i, 2: 2 + len(pat1)] = pat1
        orders["o_comment"][i, 14: 14 + len(pat2)] = pat2

    # lineitem
    total = int(n_lines.sum())
    l_order = np.repeat(orders_key, n_lines)
    l_odate = np.repeat(o_orderdate, n_lines)
    ln = np.concatenate([np.arange(1, k + 1) for k in n_lines]).astype(np.int32)
    l_part = rng.integers(1, n_part + 1, total).astype(np.int32)
    # supplier must be one of the part's 4 partsupp suppliers (Q9/Q20/Q21)
    pick = rng.integers(0, 4, total)
    l_supp = ps_supp.reshape(n_part, 4)[l_part - 1, pick]
    qty = rng.integers(1, 51, total).astype(np.float32)
    price = part["p_retailprice"][l_part - 1] * qty / 10.0
    ship_delay = rng.integers(1, 122, total)
    commit_delay = rng.integers(30, 91, total)
    receipt_delay = rng.integers(1, 31, total)
    l_ship = (l_odate + ship_delay).astype(np.int32)
    l_commit = (l_odate + commit_delay).astype(np.int32)
    l_receipt = (l_ship + receipt_delay).astype(np.int32)
    today = _D("1995-06-17")
    lstat = (l_ship > today).astype(np.int32)           # 'O' if not shipped
    rflag = np.where(
        l_receipt <= today,
        rng.integers(0, 2, total) * 2,                  # 'A'(0) or 'R'(2)
        1,                                              # 'N'
    ).astype(np.int32)
    lineitem = {
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp.astype(np.int32),
        "l_linenumber": ln,
        "l_quantity": qty,
        "l_extendedprice": price.astype(np.float32),
        "l_discount": (rng.integers(0, 11, total) / 100).astype(np.float32),
        "l_tax": (rng.integers(0, 9, total) / 100).astype(np.float32),
        "l_returnflag": rflag,
        "l_linestatus": lstat,
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipmode": rng.integers(0, 7, total).astype(np.int32),
        "l_shipinstruct": rng.integers(0, 4, total).astype(np.int32),
    }

    # order status/totalprice derived from lines
    all_f = np.ones(n_ord, dtype=bool)
    any_f = np.zeros(n_ord, dtype=bool)
    order_index = np.repeat(np.arange(n_ord), n_lines)
    np.logical_and.at(all_f, order_index, lstat == 0)
    np.logical_or.at(any_f, order_index, lstat == 0)
    orders["o_orderstatus"] = np.where(all_f, 0, np.where(any_f, 2, 1)).astype(np.int32)
    tp = np.zeros(n_ord, dtype=np.float64)
    np.add.at(tp, order_index,
              lineitem["l_extendedprice"] * (1 + lineitem["l_tax"])
              * (1 - lineitem["l_discount"]))
    orders["o_totalprice"] = tp.astype(np.float32)

    return {
        "region": region, "nation": nation, "supplier": supplier,
        "customer": customer, "part": part, "partsupp": partsupp,
        "orders": orders, "lineitem": lineitem,
    }


def load_catalog(sf: float = 0.01, seed: int = 19940729) -> Catalog:
    """In-memory catalog of ``generate(sf, seed)``."""
    return Catalog.from_numpy(generate(sf, seed), S.SCHEMAS,
                              {n: (k,) for n, k in S.PRIMARY_KEYS.items()})


# fact tables are clustered (sorted) on their date column before chunking,
# so chunk min/max stats form a useful zone map for date-range predicates
# (the layout a date-partitioned warehouse table would have)
CLUSTER_KEYS = {"lineitem": "l_shipdate", "orders": "o_orderdate"}
# the tables split into ``chunks`` files a column (the others into one)
_CHUNKED = ("lineitem", "orders", "partsupp", "customer", "part")


def write_dataset(root: str, sf: float = 0.01, seed: int = 19940729,
                  chunks: int = 4,
                  cluster: bool = True) -> Dict[str, Dict[str, np.ndarray]]:
    """Generate and persist in the column-chunk format. Returns the data
    written, in its row order, so results computed from the return value
    agree with scans of the files."""
    data = generate(sf, seed)
    if cluster:
        for name, key in CLUSTER_KEYS.items():
            order = np.argsort(data[name][key], kind="stable")
            data[name] = {c: v[order] for c, v in data[name].items()}
    os.makedirs(root, exist_ok=True)
    for name, tab in data.items():
        write_table(root, name, tab, S.SCHEMAS[name],
                    chunks=chunks if name in _CHUNKED else 1)
    return data


def storage_catalog(root: str, skip_with_stats: bool = True) -> Catalog:
    """A catalog of ``ColumnChunkTable``s over ``write_dataset``'s files,
    with the primary keys the planner's capacity derivation reads."""
    cat = Catalog()
    for name in S.SCHEMAS:
        src = ColumnChunkTable(root, name, skip_with_stats)
        src.unique_keys = (S.PRIMARY_KEYS[name],)
        cat.register(src)
    return cat
