"""Serve N concurrent TPC-H clients through the port's query scheduler.

    PYTHONPATH=src python examples/serve_queries_torch.py \
        [--clients 8] [--sf 0.002] [--device cpu]

Each client is a thread that submits a small dashboard of TPC-H queries
(with priorities) and waits for its results. The session's scheduler admits
them against a device-memory budget, interleaves their morsel pipelines,
coalesces duplicate in-flight queries, and serves repeats from the result
cache: the serving behavior the paper's Presto coordinator provides for its
GPU workers. Runs on the CUDA device by default and fails when there is
none; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import threading
import time

from repro_torch import SchedulerConfig, Session
from repro_torch.tpch import dbgen, queries

# a "dashboard" of quick queries each client refreshes; repeats across
# clients are exactly what the plan/result caches and coalescing serve
DASHBOARD = (1, 6, 14, 3)


def client(session, catalog, cid: int, latencies: list, errors: list,
           results: list) -> None:
    """One synchronous client: submit the dashboard, wait for all results."""
    try:
        handles = []
        for i, qnum in enumerate(DASHBOARD):
            plan = queries.build_query(qnum, catalog, optimized=False)
            # the freshest dashboard panel is the most urgent
            handles.append(
                (qnum, session.submit(plan, priority=len(DASHBOARD) - i)))
        for qnum, h in handles:
            results.append((qnum, h.result()))
            latencies.append(h.latency)
    except Exception as exc:  # noqa: BLE001 -- surface in the summary
        errors.append((cid, exc))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--sf", type=float, default=0.002)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    catalog = dbgen.load_catalog(sf=args.sf)
    session = Session(catalog, num_workers=1, batch_rows=16384,
                      device=args.device)
    session.scheduler_config = SchedulerConfig(
        memory_budget=512 << 20, max_concurrency=8,
        max_queue=args.clients * len(DASHBOARD))

    latencies: list = []
    errors: list = []
    results: list = []
    threads = [threading.Thread(target=client,
                                args=(session, catalog, c, latencies, errors,
                                      results))
               for c in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    session.scheduler().close()

    if errors:
        raise SystemExit(f"{len(errors)} clients failed: {errors[:3]}")

    latencies.sort()
    n = len(latencies)
    stats = session.scheduler().stats()
    print(f"served {n} queries from {args.clients} clients on "
          f"{session.device} in {wall:.2f}s ({n / wall:.1f} q/s)")
    print(f"latency p50={latencies[n // 2] * 1e3:.1f}ms "
          f"p95={latencies[min(n - 1, int(n * 0.95))] * 1e3:.1f}ms "
          f"max={latencies[-1] * 1e3:.1f}ms")
    print(f"scheduler: completed={stats['completed']} "
          f"coalesced={stats['coalesced']} "
          f"result_cache_hits={stats['result_cache_hits']} "
          f"plan_cache_hits={stats['plan_cache_hits']} "
          f"rejected={stats['rejected']}")
    return {"results": results, "stats": stats}


if __name__ == "__main__":
    main()
