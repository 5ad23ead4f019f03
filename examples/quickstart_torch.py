"""Quickstart for the PyTorch/CUDA port: the fluent builder and a
distributed TPC-H query on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the CUDA device by default and fails when there is none; pass
``--device cpu`` to run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import ICIExchange, Session
from repro_torch.core import dtypes as dt
from repro_torch.core.expr import col
from repro_torch.tpch import dbgen, queries

WORKERS = 4


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--sf", type=float, default=0.002)
    args = parser.parse_args(argv)

    # 1) a tiny ad-hoc query on your own data, in the fluent builder API:
    #    every step validates column names and types against the propagated
    #    schema, and .collect() runs the plan through the rule-based
    #    optimizer (predicate pushdown, column pruning, join distribution,
    #    capacity hints) before the driver executes it on the device.
    catalog = dbgen.load_catalog(sf=args.sf)        # TPC-H-like tables
    rng = np.random.default_rng(0)
    catalog.register_numpy(
        "events",
        {"user": rng.integers(0, 100, 5000),
         "amount": rng.random(5000).astype(np.float32) * 50},
        {"user": dt.INT32, "amount": dt.FLOAT32},
        unique_keys=())

    session = Session(catalog, num_workers=WORKERS, exchange=ICIExchange(),
                      batch_rows=4096, device=args.device)

    top_spenders = (session.table("events")
                    .filter(col("amount") > 10.0)
                    .group_by("user")
                    .agg(spend=("sum", "amount"))
                    .order_by("spend", descending=[True], limit=5))

    print(top_spenders.explain())                   # plan before/after rules
    top = top_spenders.collect()
    print("\ntop spenders:", [(int(u), round(float(s), 1))
                              for u, s in zip(top["user"], top["spend"])])

    # 2) a real TPC-H query at W workers: the rows move between the
    #    workers' tables on the device and never pass through the host
    q5 = queries.build_query(5, catalog, num_workers=WORKERS)
    res = session.execute(q5)
    print(f"\nTPC-H Q5 (revenue per nation) on {session.device}:")
    for n, r in zip(res["n_name"], res["revenue"]):
        print(f"  nation={int(n):2d} revenue={float(r):14.2f}")
    moved = session.executor_stats()["exchanges"].values()
    print(f"\nexchange: rounds={sum(e['rounds'] for e in moved)} "
          f"rows_moved={sum(e['rows_moved'] for e in moved)} "
          f"host_staged_bytes={sum(e['host_staged_bytes'] for e in moved)}")
    return {"top": top, "q5": res}


if __name__ == "__main__":
    main()
