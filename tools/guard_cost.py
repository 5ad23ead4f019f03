#!/usr/bin/env python3
"""What the device guard around every C entry point costs on one card.

Every C entry of the port runs with its tensors' device current
(``kernels.build.function(..., device=)`` wraps the call in
``torch.cuda.device``). On a one-card run that device is current already,
so the guard adds host time and nothing else. This script measures it in
one process, the guarded ``build.function`` against one that returns the
bare ctypes entry (the form the entries had before the guard), in turns:

1. host microseconds a call of three wrappers at a small size (4,096
   rows, so the host's share dominates): ``hash_probe``,
   ``segmented_sum`` and ``partition_histogram`` at W=4;
2. the 22 TPC-H queries at SF 1 (``--sf``) off the mesh, at W=1 and at
   W=4 over ICI: each query's median wall over ``--reps`` runs a form,
   and the sums.

Run from the repository root on a machine with a CUDA card::

    python3 tools/guard_cost.py [--sf 1.0] [--reps 5]

Both forms launch the same kernels on the same inputs; per-device state
in the C sources (the SM counts and occupancy looked up by device) is in
both.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def bare_function(build):
    """``build.function`` without the device guard."""
    def function(name, symbol, argtypes, restype=ctypes.c_int, *, device):
        fn = getattr(build.library(name), symbol)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, restype
        return fn
    return function


def per_call_us(torch, call, n_calls: int = 2000) -> float:
    """Host microseconds a call over ``n_calls`` back-to-back calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_calls * 1e6


def wrappers(torch):
    """(name, a call of the wrapper at 4,096 rows) of three wrappers."""
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import radix_histogram as rh
    from repro_torch.kernels import segmented_agg as seg
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = 4096
    keys = torch.randint(0, 1 << 20, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device="cuda")
    tk, tv = hp.build_table(keys, vals, 8192)
    gids = torch.randint(0, 16, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    floats = torch.rand(n, generator=gen, device="cuda")
    srcs = [[keys[i::4].contiguous()] for i in range(4)]
    valid = [torch.ones(srcs[i][0].shape[0], dtype=torch.bool,
                        device="cuda") for i in range(4)]
    return [("hash_probe (row 6)", lambda: hp.hash_probe(tk, tv, keys)),
            ("segmented_sum (row 2)",
             lambda: seg.segmented_sum(gids, floats, 16)),
            ("partition_histogram W=4 (row 8)",
             lambda: rh.partition_histogram(srcs, valid, 4))]


def query_walls(torch, catalog, q: int, w: int, reps: int, forms: dict):
    """{form: [wall of each timed run]} of query ``q`` at ``w`` workers,
    the forms in turns, each warmed up once."""
    from repro_torch.core.session import Session
    from repro_torch.kernels import build
    from repro_torch.tpch import queries
    session = Session(catalog, device="cuda", num_workers=w,
                      batch_rows=1 << 20)
    plan = queries.build_query(q, catalog, num_workers=w)
    walls = {f: [] for f in forms}
    for rep in range(reps + 1):
        for form, function in forms.items():
            build.function = function
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.execute(plan)
            torch.cuda.synchronize()
            if rep:                                 # the first is a warm-up
                walls[form].append(time.perf_counter() - t0)
    return walls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("guard_cost.py needs a CUDA device")
    from repro_torch.kernels import build
    from repro_torch.tpch import dbgen
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: -")
    forms = {"guarded": build.function, "bare": bare_function(build)}

    for name, call in wrappers(torch):
        us = {f: [] for f in forms}
        call()
        for _ in range(5):
            for form, function in forms.items():
                build.function = function
                us[form].append(per_call_us(torch, call))
        print(f"{name}: host us a call, median of 5 rounds of 2000: "
              + ", ".join(f"{f} {statistics.median(v):.2f}"
                          for f, v in us.items()), flush=True)
    build.function = forms["guarded"]

    catalog = dbgen.load_catalog(sf=args.sf)
    for w in (1, 4):
        sums = {f: 0.0 for f in forms}
        for q in range(1, 23):
            walls = query_walls(torch, catalog, q, w, args.reps, forms)
            med = {f: statistics.median(v) for f, v in walls.items()}
            for f in forms:
                sums[f] += med[f]
            print(f"Q{q} W={w}: median wall "
                  + ", ".join(f"{f} {m:.4f}" for f, m in med.items()) + " s",
                  flush=True)
        print(f"W={w} sum of the 22 median walls: "
              + ", ".join(f"{f} {s:.4f} s" for f, s in sums.items())
              + f" (guarded / bare {sums['guarded'] / sums['bare']:.4f})",
              flush=True)
    build.function = forms["guarded"]


if __name__ == "__main__":
    main()
