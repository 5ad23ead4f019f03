"""Pure-numpy oracle for the 22 TPC-H queries (the port's copy of
``repro.tpch.oracle``).

Independent implementation (straight from the SQL semantics, not from the
engine's plans) used to validate every engine execution. Operates on the
dict-of-arrays output of ``dbgen.generate()``. ``ORACLES[q](data)`` is
host numpy only: it runs beside a query on the card to check its answer.
"""

from __future__ import annotations


import numpy as np

from ..core import dtypes as dt
from . import schema as S

_D = dt.date_to_i32


def _year(days: np.ndarray) -> np.ndarray:
    d = (np.datetime64("1970-01-01") + days.astype("timedelta64[D]"))
    return d.astype("datetime64[Y]").astype(np.int64) + 1970


def _contains(data: np.ndarray, *parts: str) -> np.ndarray:
    out = np.zeros(len(data), dtype=bool)
    bparts = [p.encode() for p in parts]
    for i in range(len(data)):
        s = data[i].tobytes()
        pos = 0
        ok = True
        for p in bparts:
            j = s.find(p, pos)
            if j < 0:
                ok = False
                break
            pos = j + len(p)
        out[i] = ok
    return out


def _startswith(data: np.ndarray, prefix: str) -> np.ndarray:
    p = np.frombuffer(prefix.encode(), dtype=np.uint8)
    return (data[:, : len(p)] == p).all(axis=1)


def _groupby(keys, aggs):
    """keys: list of 1-D arrays; aggs: list of (name, kind, values).
    Returns (key_arrays, {name: agg_array}) group-sorted."""
    stacked = np.stack([np.asarray(k) for k in keys], axis=1)
    uniq, inverse = np.unique(stacked, axis=0, return_inverse=True)
    n = len(uniq)
    out = {}
    for name, kind, vals in aggs:
        if kind == "count":
            a = np.zeros(n, dtype=np.int64)
            np.add.at(a, inverse, 1)
        elif kind == "sum":
            a = np.zeros(n, dtype=np.float64)
            np.add.at(a, inverse, np.asarray(vals, dtype=np.float64))
        elif kind == "avg":
            s = np.zeros(n, dtype=np.float64)
            c = np.zeros(n, dtype=np.int64)
            np.add.at(s, inverse, np.asarray(vals, dtype=np.float64))
            np.add.at(c, inverse, 1)
            a = s / np.maximum(c, 1)
        elif kind == "min":
            a = np.full(n, np.inf)
            np.minimum.at(a, inverse, np.asarray(vals, dtype=np.float64))
        elif kind == "max":
            a = np.full(n, -np.inf)
            np.maximum.at(a, inverse, np.asarray(vals, dtype=np.float64))
        elif kind == "first":
            a = np.zeros(n, dtype=np.asarray(vals).dtype)
            # first occurrence wins: reverse so earliest write lands last
            a[inverse[::-1]] = np.asarray(vals)[::-1]
        out[name] = a
    return [uniq[:, i] for i in range(len(keys))], out


def _lookup(build_keys: np.ndarray, build_vals, probe_keys: np.ndarray):
    """probe -> (matched mask, gathered values list). build keys unique."""
    if len(build_keys) == 0:
        matched = np.zeros(len(probe_keys), dtype=bool)
        return matched, [np.zeros(len(probe_keys),
                                  dtype=np.asarray(v).dtype)
                         for v in build_vals]
    order = np.argsort(build_keys, kind="stable")
    sk = build_keys[order]
    pos = np.searchsorted(sk, probe_keys)
    pos_c = np.clip(pos, 0, len(sk) - 1)
    matched = sk[pos_c] == probe_keys
    idx = order[pos_c]
    return matched, [np.asarray(v)[idx] for v in build_vals]


def _pack2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a.astype(np.int64) * 2_000_003 + b.astype(np.int64)


def q1(d):
    li = d["lineitem"]
    m = li["l_shipdate"] <= _D("1998-12-01") - 90
    disc = li["l_extendedprice"] * (1 - li["l_discount"])
    charge = disc * (1 + li["l_tax"])
    keys, out = _groupby(
        [li["l_returnflag"][m], li["l_linestatus"][m]],
        [("sum_qty", "sum", li["l_quantity"][m]),
         ("sum_base_price", "sum", li["l_extendedprice"][m]),
         ("sum_disc_price", "sum", disc[m]),
         ("sum_charge", "sum", charge[m]),
         ("avg_qty", "avg", li["l_quantity"][m]),
         ("avg_price", "avg", li["l_extendedprice"][m]),
         ("avg_disc", "avg", li["l_discount"][m]),
         ("count_order", "count", None)])
    out["l_returnflag"], out["l_linestatus"] = keys
    return out   # unique() returns sorted keys == ORDER BY rf, ls


def q2(d):
    p, ps, s, n, r = (d[k] for k in ("part", "partsupp", "supplier",
                                     "nation", "region"))
    eu = r["r_regionkey"][r["r_name"] == S.REGIONS.index("EUROPE")]
    nat_eu = np.isin(n["n_regionkey"], eu)
    eu_nations = n["n_nationkey"][nat_eu]
    s_in = np.isin(s["s_nationkey"], eu_nations)
    smap = {k: i for i, k in enumerate(s["s_suppkey"])}
    pmask = (p["p_size"] == 15) & np.isin(
        p["p_type"], [i for i, t in enumerate(S.TYPES) if t.endswith("BRASS")])
    pset = {k: i for i, k in enumerate(p["p_partkey"][pmask])}
    rows = []
    for i in range(len(ps["ps_partkey"])):
        pk, sk = int(ps["ps_partkey"][i]), int(ps["ps_suppkey"][i])
        si = smap[sk]
        if pk in pset and s_in[si]:
            rows.append((pk, si, float(ps["ps_supplycost"][i])))
    if not rows:
        return {k: np.zeros(0) for k in ("s_acctbal", "p_partkey")}
    mincost = {}
    for pk, si, cost in rows:
        mincost[pk] = min(mincost.get(pk, np.inf), cost)
    nname = {int(k): int(v) for k, v in zip(n["n_nationkey"], n["n_name"])}
    recs = []
    for pk, si, cost in rows:
        if cost == mincost[pk]:
            recs.append({
                "s_acctbal": float(s["s_acctbal"][si]),
                "s_name": s["s_name"][si].tobytes(),
                "n_name": nname[int(s["s_nationkey"][si])],
                "p_partkey": pk,
                "p_mfgr": int(p["p_mfgr"][list(pset).index(pk) if False else np.searchsorted(p["p_partkey"], pk)]),
                "s_address": s["s_address"][si].tobytes(),
                "s_phone": s["s_phone"][si].tobytes(),
                "s_comment": s["s_comment"][si].tobytes(),
            })
    recs.sort(key=lambda x: (-x["s_acctbal"], x["n_name"], x["s_name"],
                             x["p_partkey"]))
    recs = recs[:100]
    return {k: np.array([r[k] for r in recs]) for k in
            ("s_acctbal", "s_name", "n_name", "p_partkey")}


def q3(d):
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    building = S.SEGMENTS.index("BUILDING")
    cset = set(c["c_custkey"][c["c_mktsegment"] == building].tolist())
    om = (o["o_orderdate"] < _D("1995-03-15")) \
        & np.array([k in cset for k in o["o_custkey"]])
    ok = o["o_orderkey"][om]
    matched, (odate, oprio) = _lookup(ok, [o["o_orderdate"][om],
                                           o["o_shippriority"][om]],
                                      li["l_orderkey"])
    lm = matched & (li["l_shipdate"] > _D("1995-03-15"))
    rev = (li["l_extendedprice"] * (1 - li["l_discount"]))[lm]
    keys, out = _groupby([li["l_orderkey"][lm]],
                         [("revenue", "sum", rev),
                          ("o_orderdate", "first", odate[lm]),
                          ("o_shippriority", "first", oprio[lm])])
    order = np.lexsort((out["o_orderdate"], -out["revenue"]))[:10]
    return {"l_orderkey": keys[0][order], "revenue": out["revenue"][order],
            "o_orderdate": out["o_orderdate"][order],
            "o_shippriority": out["o_shippriority"][order]}


def q4(d):
    o, li = d["orders"], d["lineitem"]
    late = set(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]].tolist())
    om = (o["o_orderdate"] >= _D("1993-07-01")) \
        & (o["o_orderdate"] < _D("1993-10-01")) \
        & np.array([k in late for k in o["o_orderkey"]])
    keys, out = _groupby([o["o_orderpriority"][om]],
                         [("order_count", "count", None)])
    return {"o_orderpriority": keys[0], "order_count": out["order_count"]}


def q5(d):
    c, o, li, s, n, r = (d[k] for k in ("customer", "orders", "lineitem",
                                        "supplier", "nation", "region"))
    asia = r["r_regionkey"][r["r_name"] == S.REGIONS.index("ASIA")]
    nat_asia = n["n_nationkey"][np.isin(n["n_regionkey"], asia)]
    nname = dict(zip(n["n_nationkey"].tolist(), n["n_name"].tolist()))
    om = (o["o_orderdate"] >= _D("1994-01-01")) & (o["o_orderdate"] < _D("1995-01-01"))
    cm, (cnat,) = _lookup(c["c_custkey"], [c["c_nationkey"]], o["o_custkey"])
    om = om & cm
    lm, (lcnat,) = _lookup(o["o_orderkey"][om], [cnat[om]], li["l_orderkey"])
    sm, (snat,) = _lookup(s["s_suppkey"], [s["s_nationkey"]], li["l_suppkey"])
    keep = lm & sm & (lcnat == snat) & np.isin(snat, nat_asia)
    rev = (li["l_extendedprice"] * (1 - li["l_discount"]))[keep]
    names = np.array([nname[k] for k in snat[keep]])
    keys, out = _groupby([names], [("revenue", "sum", rev)])
    order = np.argsort(-out["revenue"])
    return {"n_name": keys[0][order], "revenue": out["revenue"][order]}


def q6(d):
    li = d["lineitem"]
    m = ((li["l_shipdate"] >= _D("1994-01-01"))
         & (li["l_shipdate"] < _D("1995-01-01"))
         & (li["l_discount"] >= 0.05 - 1e-9) & (li["l_discount"] <= 0.07 + 1e-9)
         & (li["l_quantity"] < 24))
    return {"revenue": np.array(
        [(li["l_extendedprice"][m] * li["l_discount"][m]).sum()])}


def q7(d):
    c, o, li, s, n = (d[k] for k in ("customer", "orders", "lineitem",
                                     "supplier", "nation"))
    fr, de = S.NATIONS.index("FRANCE"), S.NATIONS.index("GERMANY")
    sm, (snat,) = _lookup(s["s_suppkey"], [s["s_nationkey"]], li["l_suppkey"])
    cm, (cnat,) = _lookup(c["c_custkey"], [c["c_nationkey"]], o["o_custkey"])
    olm, (ocnat,) = _lookup(o["o_orderkey"][cm], [cnat[cm]], li["l_orderkey"])
    date_m = (li["l_shipdate"] >= _D("1995-01-01")) & (li["l_shipdate"] <= _D("1996-12-31"))
    pair = ((snat == fr) & (ocnat == de)) | ((snat == de) & (ocnat == fr))
    keep = sm & olm & date_m & pair
    vol = (li["l_extendedprice"] * (1 - li["l_discount"]))[keep]
    keys, out = _groupby([snat[keep], ocnat[keep], _year(li["l_shipdate"][keep])],
                         [("revenue", "sum", vol)])
    return {"supp_nation": keys[0], "cust_nation": keys[1],
            "l_year": keys[2], "revenue": out["revenue"]}


def q8(d):
    c, o, li, s, n, r, p = (d[k] for k in ("customer", "orders", "lineitem",
                                           "supplier", "nation", "region",
                                           "part"))
    target = S.TYPES.index("ECONOMY ANODIZED STEEL")
    brazil = S.NATIONS.index("BRAZIL")
    america = r["r_regionkey"][r["r_name"] == S.REGIONS.index("AMERICA")]
    nat_am = n["n_nationkey"][np.isin(n["n_regionkey"], america)]
    pm = set(p["p_partkey"][p["p_type"] == target].tolist())
    cm, (cnat,) = _lookup(c["c_custkey"], [c["c_nationkey"]], o["o_custkey"])
    okm = cm & np.isin(cnat, nat_am) \
        & (o["o_orderdate"] >= _D("1995-01-01")) \
        & (o["o_orderdate"] <= _D("1996-12-31"))
    olm, (odate,) = _lookup(o["o_orderkey"][okm], [o["o_orderdate"][okm]],
                            li["l_orderkey"])
    sm, (snat,) = _lookup(s["s_suppkey"], [s["s_nationkey"]], li["l_suppkey"])
    keep = olm & sm & np.array([k in pm for k in li["l_partkey"]])
    vol = (li["l_extendedprice"] * (1 - li["l_discount"]))[keep]
    yr = _year(odate[keep])
    isbr = (snat[keep] == brazil)
    keys, out = _groupby([yr], [("nat", "sum", vol * isbr),
                                ("total", "sum", vol)])
    return {"o_year": keys[0], "mkt_share": out["nat"] / out["total"]}


def q9(d):
    p, ps, s, o, li, n = (d[k] for k in ("part", "partsupp", "supplier",
                                         "orders", "lineitem", "nation"))
    green = set(p["p_partkey"][_contains(p["p_name"], "green")].tolist())
    sm, (snat,) = _lookup(s["s_suppkey"], [s["s_nationkey"]], li["l_suppkey"])
    om, (odate,) = _lookup(o["o_orderkey"], [o["o_orderdate"]], li["l_orderkey"])
    psk = _pack2(ps["ps_partkey"], ps["ps_suppkey"])
    lik = _pack2(li["l_partkey"], li["l_suppkey"])
    pm_, (cost,) = _lookup(psk, [ps["ps_supplycost"]], lik)
    keep = sm & om & pm_ & np.array([k in green for k in li["l_partkey"]])
    amount = (li["l_extendedprice"] * (1 - li["l_discount"])
              - cost * li["l_quantity"])[keep]
    nname = dict(zip(n["n_nationkey"].tolist(), n["n_name"].tolist()))
    names = np.array([nname[k] for k in snat[keep]])
    keys, out = _groupby([names, _year(odate[keep])],
                         [("sum_profit", "sum", amount)])
    order = np.lexsort((-keys[1], keys[0]))
    return {"nation": keys[0][order], "o_year": keys[1][order],
            "sum_profit": out["sum_profit"][order]}


def q10(d):
    c, o, li, n = (d[k] for k in ("customer", "orders", "lineitem", "nation"))
    om = (o["o_orderdate"] >= _D("1993-10-01")) & (o["o_orderdate"] < _D("1994-01-01"))
    lm, (lcust,) = _lookup(o["o_orderkey"][om], [o["o_custkey"][om]],
                           li["l_orderkey"])
    keep = lm & (li["l_returnflag"] == S.RETURNFLAGS.index("R"))
    rev = (li["l_extendedprice"] * (1 - li["l_discount"]))[keep]
    keys, out = _groupby([lcust[keep]], [("revenue", "sum", rev)])
    cm, (bal, cnat, cname) = _lookup(c["c_custkey"],
                                     [c["c_acctbal"], c["c_nationkey"],
                                      np.arange(len(c["c_custkey"]))],
                                     keys[0])
    order = np.argsort(-out["revenue"], kind="stable")[:20]
    return {"c_custkey": keys[0][order], "revenue": out["revenue"][order],
            "c_acctbal": bal[order]}


def q11(d, fraction=None):
    ps, s, n = d["partsupp"], d["supplier"], d["nation"]
    if fraction is None:
        fraction = 0.0001 / max(len(s["s_suppkey"]) / 10000.0, 1e-9)
    de = n["n_nationkey"][n["n_name"] == S.NATIONS.index("GERMANY")]
    sset = set(s["s_suppkey"][np.isin(s["s_nationkey"], de)].tolist())
    m = np.array([k in sset for k in ps["ps_suppkey"]])
    value = (ps["ps_supplycost"] * ps["ps_availqty"])[m]
    keys, out = _groupby([ps["ps_partkey"][m]], [("value", "sum", value)])
    total = out["value"].sum()
    keep = out["value"] > total * fraction
    order = np.argsort(-out["value"][keep], kind="stable")
    return {"ps_partkey": keys[0][keep][order],
            "value": out["value"][keep][order]}


def q12(d):
    o, li = d["orders"], d["lineitem"]
    modes = [S.SHIPMODES.index("MAIL"), S.SHIPMODES.index("SHIP")]
    m = (np.isin(li["l_shipmode"], modes)
         & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"])
         & (li["l_receiptdate"] >= _D("1994-01-01"))
         & (li["l_receiptdate"] < _D("1995-01-01")))
    _, (oprio,) = _lookup(o["o_orderkey"], [o["o_orderpriority"]],
                          li["l_orderkey"])
    hi = np.isin(oprio, [S.PRIORITIES.index("1-URGENT"),
                         S.PRIORITIES.index("2-HIGH")])
    keys, out = _groupby([li["l_shipmode"][m]],
                         [("high_line_count", "sum", hi[m].astype(np.int64)),
                          ("low_line_count", "sum", (~hi[m]).astype(np.int64))])
    return {"l_shipmode": keys[0], "high_line_count": out["high_line_count"],
            "low_line_count": out["low_line_count"]}


def q13(d):
    c, o = d["customer"], d["orders"]
    om = ~_contains(o["o_comment"], "special", "requests")
    keys, out = _groupby([o["o_custkey"][om]], [("cnt", "count", None)])
    cm, (cnt,) = _lookup(keys[0], [out["cnt"]], c["c_custkey"])
    c_count = np.where(cm, cnt, 0)
    keys2, out2 = _groupby([c_count], [("custdist", "count", None)])
    order = np.lexsort((-keys2[0], -out2["custdist"]))
    return {"c_count": keys2[0][order], "custdist": out2["custdist"][order]}


def q14(d):
    li, p = d["lineitem"], d["part"]
    m = (li["l_shipdate"] >= _D("1995-09-01")) & (li["l_shipdate"] < _D("1995-10-01"))
    _, (ptype,) = _lookup(p["p_partkey"], [p["p_type"]], li["l_partkey"])
    promo = np.isin(ptype, [i for i, t in enumerate(S.TYPES)
                            if t.startswith("PROMO")])
    rev = li["l_extendedprice"] * (1 - li["l_discount"])
    return {"promo_revenue": np.array(
        [100.0 * rev[m & promo].sum() / rev[m].sum()])}


def q15(d):
    li, s = d["lineitem"], d["supplier"]
    m = (li["l_shipdate"] >= _D("1996-01-01")) & (li["l_shipdate"] < _D("1996-04-01"))
    rev = (li["l_extendedprice"] * (1 - li["l_discount"]))[m]
    keys, out = _groupby([li["l_suppkey"][m]], [("total_revenue", "sum", rev)])
    mx = out["total_revenue"].max()
    best = np.isclose(out["total_revenue"], mx)
    sk = np.sort(keys[0][best])
    return {"s_suppkey": sk,
            "total_revenue": np.full(len(sk), mx)}


def q16(d):
    p, ps, s = d["part"], d["partsupp"], d["supplier"]
    b45 = list(S.BRANDS).index("Brand#45")
    medpol = [i for i, t in enumerate(S.TYPES) if t.startswith("MEDIUM POLISHED")]
    sizes = [49, 14, 23, 45, 19, 3, 36, 9]
    pm = ((p["p_brand"] != b45) & ~np.isin(p["p_type"], medpol)
          & np.isin(p["p_size"], sizes))
    bad = set(s["s_suppkey"][_contains(s["s_comment"], "Customer",
                                       "Complaints")].tolist())
    pmm, (brand, ptype, psize) = _lookup(p["p_partkey"][pm],
                                         [p["p_brand"][pm], p["p_type"][pm],
                                          p["p_size"][pm]], ps["ps_partkey"])
    keep = pmm & np.array([k not in bad for k in ps["ps_suppkey"]])
    quad = np.stack([brand[keep], ptype[keep], psize[keep],
                     ps["ps_suppkey"][keep]], axis=1)
    uniq = np.unique(quad, axis=0)
    keys, out = _groupby([uniq[:, 0], uniq[:, 1], uniq[:, 2]],
                         [("supplier_cnt", "count", None)])
    order = np.lexsort((keys[2], keys[1], keys[0], -out["supplier_cnt"]))
    return {"p_brand": keys[0][order], "p_type": keys[1][order],
            "p_size": keys[2][order], "supplier_cnt": out["supplier_cnt"][order]}


def q17(d):
    li, p = d["lineitem"], d["part"]
    b23 = list(S.BRANDS).index("Brand#23")
    box = list(S.CONTAINERS).index("MED BOX")
    pset = set(p["p_partkey"][(p["p_brand"] == b23)
                              & (p["p_container"] == box)].tolist())
    m = np.array([k in pset for k in li["l_partkey"]])
    keys, out = _groupby([li["l_partkey"][m]], [("avg", "avg", li["l_quantity"][m])])
    _, (avg,) = _lookup(keys[0], [out["avg"]], li["l_partkey"])
    keep = m & (li["l_quantity"] < 0.2 * avg)
    return {"avg_yearly": np.array([li["l_extendedprice"][keep].sum() / 7.0])}


def q18(d):
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    keys, out = _groupby([li["l_orderkey"]], [("sum_qty", "sum", li["l_quantity"])])
    bigm = out["sum_qty"] > 300
    om, (sq,) = _lookup(keys[0][bigm], [out["sum_qty"][bigm]], o["o_orderkey"])
    cm, (cname_i,) = _lookup(c["c_custkey"], [np.arange(len(c["c_custkey"]))],
                             o["o_custkey"])
    keep = om & cm
    order = np.lexsort((o["o_orderdate"][keep], -o["o_totalprice"][keep]))[:100]
    return {"o_orderkey": o["o_orderkey"][keep][order],
            "o_totalprice": o["o_totalprice"][keep][order],
            "o_orderdate": o["o_orderdate"][keep][order],
            "sum_qty": sq[keep][order],
            "c_custkey": o["o_custkey"][keep][order]}


def q19(d):
    li, p = d["lineitem"], d["part"]
    sm_ = S.SHIPMODES
    lm = (np.isin(li["l_shipmode"], [sm_.index("AIR"), sm_.index("REG AIR")])
          & (li["l_shipinstruct"] == S.SHIPINSTRUCT.index("DELIVER IN PERSON")))
    _, (brand, size, cont) = _lookup(p["p_partkey"],
                                     [p["p_brand"], p["p_size"],
                                      p["p_container"]], li["l_partkey"])
    def bracket(bname, conts, qlo, qhi, smax):
        b = list(S.BRANDS).index(bname)
        cs = [list(S.CONTAINERS).index(x) for x in conts]
        return ((brand == b) & np.isin(cont, cs)
                & (li["l_quantity"] >= qlo) & (li["l_quantity"] <= qhi)
                & (size >= 1) & (size <= smax))
    m = lm & (bracket("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5)
              | bracket("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10)
              | bracket("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15))
    rev = li["l_extendedprice"] * (1 - li["l_discount"])
    return {"revenue": np.array([rev[m].sum()])}


def q20(d):
    p, ps, s, n, li = (d[k] for k in ("part", "partsupp", "supplier",
                                      "nation", "lineitem"))
    forest = set(p["p_partkey"][_startswith(p["p_name"], "forest")].tolist())
    m94 = (li["l_shipdate"] >= _D("1994-01-01")) & (li["l_shipdate"] < _D("1995-01-01"))
    keys, out = _groupby([_pack2(li["l_partkey"][m94], li["l_suppkey"][m94])],
                         [("qty", "sum", li["l_quantity"][m94])])
    psm, (qty,) = _lookup(keys[0], [out["qty"]],
                          _pack2(ps["ps_partkey"], ps["ps_suppkey"]))
    keep = psm & np.array([k in forest for k in ps["ps_partkey"]]) \
        & (ps["ps_availqty"] > 0.5 * qty)
    sset = set(ps["ps_suppkey"][keep].tolist())
    ca = n["n_nationkey"][n["n_name"] == S.NATIONS.index("CANADA")]
    sm = np.isin(s["s_nationkey"], ca) & np.array(
        [k in sset for k in s["s_suppkey"]])
    names = [s["s_name"][i].tobytes() for i in np.where(sm)[0]]
    order = np.argsort(names)
    return {"s_name": np.array(names)[order],
            "s_suppkey": s["s_suppkey"][sm][order]}


def q21(d):
    s, o, li, n = d["supplier"], d["orders"], d["lineitem"], d["nation"]
    pairs = np.unique(_pack2(li["l_orderkey"], li["l_suppkey"]))
    okeys, ocnt = np.unique(pairs // 2_000_003, return_counts=True)
    late = li["l_receiptdate"] > li["l_commitdate"]
    lpairs = np.unique(_pack2(li["l_orderkey"][late], li["l_suppkey"][late]))
    lkeys, lcnt = np.unique(lpairs // 2_000_003, return_counts=True)
    fstat = set(o["o_orderkey"][o["o_orderstatus"]
                                == S.ORDERSTATUS.index("F")].tolist())
    sa = n["n_nationkey"][n["n_name"] == S.NATIONS.index("SAUDI ARABIA")]
    sm, (snat, sidx) = _lookup(s["s_suppkey"],
                               [s["s_nationkey"], np.arange(len(s["s_suppkey"]))],
                               li["l_suppkey"])
    am, (nsupp,) = _lookup(okeys, [ocnt], li["l_orderkey"])
    bm, (nlate,) = _lookup(lkeys, [lcnt], li["l_orderkey"])
    keep = (late & sm & np.isin(snat, sa) & am & bm
            & np.array([k in fstat for k in li["l_orderkey"]])
            & (nsupp >= 2) & (nlate == 1))
    names = np.array([s["s_name"][i].tobytes() for i in sidx[keep]])
    keys, out = _groupby([names], [("numwait", "count", None)])
    order = np.lexsort((keys[0], -out["numwait"]))[:100]
    return {"s_name": keys[0][order], "numwait": out["numwait"][order]}


def q22(d):
    c, o = d["customer"], d["orders"]
    codes = [13, 31, 23, 29, 30, 18, 17]
    code = (c["c_phone"][:, 0] - ord("0")) * 10 + (c["c_phone"][:, 1] - ord("0"))
    m = np.isin(code, codes)
    avg = c["c_acctbal"][(m) & (c["c_acctbal"] > 0)].mean()
    has_orders = set(o["o_custkey"].tolist())
    keep = m & (c["c_acctbal"] > avg) \
        & np.array([k not in has_orders for k in c["c_custkey"]])
    keys, out = _groupby([code[keep]],
                         [("numcust", "count", None),
                          ("totacctbal", "sum", c["c_acctbal"][keep])])
    return {"cntrycode": keys[0], "numcust": out["numcust"],
            "totacctbal": out["totacctbal"]}


ORACLES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
           10: q10, 11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16,
           17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22}
