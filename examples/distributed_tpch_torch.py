"""Distributed TPC-H on a worker mesh with both exchange protocols, through
the PyTorch/CUDA port: the paper's Figure 5 experiment in miniature.

    PYTHONPATH=src python examples/distributed_tpch_torch.py [--device cpu]

Without ``--device`` the mesh takes ``min(torch.cuda.device_count(), 8)``
cards, one worker a card (four workers on the one card of a one-card
host), and fails when there is no card. ``--device cpu`` (or
``--device cuda:1``) puts every worker on that one device. Each query runs
once to warm up, then once timed, with ``ICIExchange`` (rows move device
to device) and with ``HostExchange`` (every exchanged byte staged through
host memory).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import HostExchange, ICIExchange, Session
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh
from repro_torch.tpch import dbgen, queries

QUERIES = (1, 5, 9, 13)


def _mesh(device):
    if device is not None:
        return EngineMesh([torch.device(device)])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("no CUDA device is visible; pass --device cpu")
    return make_engine_mesh(min(cards, 8))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="one torch device for every worker (default: "
                             "a mesh of the visible cards)")
    parser.add_argument("--sf", type=float, default=0.002)
    args = parser.parse_args(argv)

    mesh = _mesh(args.device)
    workers = mesh.size if mesh.size > 1 else 4
    print(f"mesh={[str(d) for d in mesh.devices]} workers={workers}")
    catalog = dbgen.load_catalog(sf=args.sf)
    results = {}
    for q in QUERIES:
        plan = queries.build_query(q, catalog, num_workers=workers)
        row = [f"q{q}"]
        for name, ex in (("ICI", ICIExchange(mesh=mesh)),
                         ("Host", HostExchange())):
            session = Session(catalog, num_workers=workers, exchange=ex,
                              batch_rows=8192, mesh=mesh)
            session.execute(plan)           # warm
            t0 = time.perf_counter()
            out = session.execute(plan)
            if mesh.devices[0].type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            staged = sum(e["host_staged_bytes"] for e in
                         session.executor_stats()["exchanges"].values())
            results[(q, name)] = {"result": out, "wall_s": wall,
                                  "staged_bytes": staged}
            row.append(f"{name}={wall * 1e3:7.1f}ms staged={staged:>9d}B")
        print("  ".join(row))
    print("\nICI keeps the working set in device memory (staged=0); the "
          "host protocol round-trips every exchanged byte (paper §3.3).")
    return results


if __name__ == "__main__":
    main()
