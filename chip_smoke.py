#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, all started together) and prints the seconds;
3. checks each kernel against its plain PyTorch version on the card, on
   the shapes the main path gives it, with the tolerance stated beside each;
4. times each kernel, its plain version and, where one PyTorch call computes
   the same function, that call (``library_ms``), with CUDA events over warm
   runs, and computes each kernel's bound from its inputs;
5. generates TPC-H at SF 1 with the port's ``dbgen`` and runs Q6 and Q1
   through ``Session(device="cuda", batch_rows=1 << 20).execute``, with the
   launch counters set to 0 just before each query and read just after; each
   result must match the same plan run by ``Session(device="cpu")`` (exact
   for keys and counts, rtol 2e-3 for floats);
6. prints one ``{"kernels": [...]}`` line, then the card line again;
7. prints as its last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without printing the last line. The script
imports only the port, torch, numpy and the standard library; it fails when
``torch.cuda.is_available()`` is false or when ``src/repro_torch`` is not
beside it. ``--profile DIR`` adds, after phase 5, each kernel's device time
per launch at the main path's shapes and one ``torch.profiler`` run of each
query, whose device time by kernel (and trace) it writes into DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# memory rate of the card by name (bytes/s), from NVIDIA's data sheets; the
# H100 SXM part is the default
_MEM_RATE = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# float32 rate outside the tensor cores (operations/s), H100 SXM data sheet
_F32_RATE = 67e12
_MAIN_ROWS = 1 << 20
_SF = 1.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    return 3.35e12


def time_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / _F32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3 + 4: each kernel against its plain version, then timed
# ---------------------------------------------------------------------------

def check_segmented(torch, seg, rate, rows):
    """segmented_sum / segmented_int_sum at the main path's shapes (sorted
    ids, dead rows carrying id G, G = 16) plus G = 4096 (unsorted) and an
    int32 wrap case."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = "cuda"
    results = {}

    def inputs(n, g, sort):
        gids = torch.randint(0, g + 1, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        if sort:
            gids = torch.sort(gids).values
        return gids

    # float sums: |kernel - plain| <= 1e-4 * sum(|v|) of the group + 1e-6,
    # the reordering error of ~10^3 float32 partial sums added by atomics
    for g, sort in ((16, True), (4096, False)):
        gids = inputs(rows, g, sort)
        vals = torch.randn(rows, generator=gen, device=dev)
        got = seg.segmented_sum(gids, vals, g)
        want = seg.segmented_sum_plain(gids, vals, g)
        scale = seg.segmented_sum_plain(gids, vals.abs(), g)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool((err <= 1e-4 * scale + 1e-6).all()):
            fail(f"segmented_sum G={g}: max err {float(err.max())}")
        print(f"check segmented_sum rows={rows} G={g}: max_abs_err="
              f"{float(err.max())} (tol 1e-4*sum|v|)")
        results.setdefault("segmented_sum", (gids, vals, g, float(err.max())))
    # int sums: bit-exact, counts at the main path's shape, then a wrap case
    gids = inputs(rows, 16, True)
    ones = (gids < 16).to(torch.int32)
    got = seg.segmented_int_sum(gids, ones, 16)
    want = seg.segmented_int_sum_plain(gids, ones, 16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("segmented_int_sum counts differ from the plain version")
    results["segmented_int_sum"] = (gids, ones, 16, 0.0)
    big = torch.randint(1 << 29, 1 << 30, (rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    wrap_ids = inputs(rows, 16, True)
    got = seg.segmented_int_sum(wrap_ids, big, 16)
    want = seg.segmented_int_sum_plain(wrap_ids, big, 16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("segmented_int_sum wrap case differs from the plain version")
    print(f"check segmented_int_sum rows={rows} G=16 counts and int32 wrap: "
          "bit-exact")

    rows_out, launchers = [], {}
    for name, kernel, plain in (
            ("segmented_sum", seg.segmented_sum, seg.segmented_sum_plain),
            ("segmented_int_sum", seg.segmented_int_sum,
             seg.segmented_int_sum_plain)):
        gids, vals, g, err = results[name]
        launchers[name] = (lambda k=kernel, a=gids, v=vals, n=g: k(a, v, n))
        buf = torch.zeros(g + 1, dtype=vals.dtype, device=dev)
        ms = time_ms(torch, launchers[name])
        plain_ms = time_ms(torch, lambda: plain(gids, vals, g))
        lib_ms = time_ms(torch, lambda: buf.index_add_(0, gids, vals))
        b, by = bound_ms(rows * 8 + g * 4, rows, rate)
        rows_out.append(dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/segmented_agg.cu",
                             replaces=("src/repro/kernels/segmented_agg.py:80"
                                       if name == "segmented_sum" else
                                       "src/repro/kernels/segmented_agg.py:131"),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=lib_ms))
    return rows_out, launchers


def fused_case(queries, morsel, q):
    """The fused stages of query ``q`` as FusedMorsel receives them: the
    scan's pushed-down filter, then the projection."""
    plan = queries.QUERIES[q](None)
    while type(plan).__name__ != "Project":
        plan = plan.child
    scan = plan.child
    stages = [(scan.filter, None), (None, tuple(plan.projections))]
    table = morsel.select(list(scan.columns))
    return table, stages


def check_fused(torch, fused, queries, morsel, rate):
    """fused_morsel_program for Q1's and Q6's stages on one morsel: output
    columns and validity must be bit-identical to ``apply_stages`` (the
    kernel rounds every float op to nearest, like the plain version)."""
    rows_out, launchers = [], {}
    for q in (1, 6):
        table, stages = fused_case(queries, morsel, q)
        program = fused.lower_stages(table, stages)
        got, _, _ = fused.fused_morsel_program(table, stages, program=program)
        want = fused.apply_stages(table, stages)
        torch.cuda.synchronize()
        if not torch.equal(got.validity, want.validity):
            fail(f"fused Q{q}: validity differs from apply_stages")
        for name in want.column_names:
            a, b = got.columns[name], want.columns[name]
            if a.dtype != b.dtype or not torch.equal(a, b):
                d = (a.double() - b.double()).abs().max()
                fail(f"fused Q{q}: column {name} differs (max {float(d)})")
        print(f"check fused_morsel_program Q{q} rows={table.capacity}: "
              f"{program.code.shape[0]} instructions, {program.n_regs} "
              f"registers, bit-identical")
        name = f"fused_morsel_program[Q{q}]"
        launchers[name] = (lambda t=table, st=stages, p=program:
                           fused.fused_morsel_program(t, st, program=p))
        ms = time_ms(torch, launchers[name])
        plain_ms = time_ms(torch, lambda: fused.apply_stages(table, stages))
        n = table.capacity
        nbytes = n * (sum(table.columns[c].element_size()
                          for c in program.in_names) + 1
                      + sum(got.columns[c].element_size()
                            for c in program.out_names) + 1)
        alu = sum(1 for op in program.code[:, 0].tolist()
                  if op >= fused.OPS["FILTER"])
        b, by = bound_ms(nbytes, n * alu, rate)
        rows_out.append(dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/fused_morsel.cu",
                             replaces="src/repro/core/fused.py:78",
                             max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=None))
    return rows_out, launchers


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def compare(q, got, want):
    """Exact for integer columns (keys, counts), rtol 2e-3 for floats."""
    import numpy as np
    if sorted(got) != sorted(want):
        fail(f"Q{q}: columns {sorted(got)} vs {sorted(want)}")
    n = len(next(iter(want.values())))
    if any(len(v) != n for v in got.values()):
        fail(f"Q{q}: row count differs from the CPU run")
    ints = [c for c in sorted(want) if want[c].dtype.kind in "iub"]
    go = np.lexsort([got[c] for c in reversed(ints)]) if ints else slice(None)
    wo = np.lexsort([want[c] for c in reversed(ints)]) if ints else slice(None)
    for c in sorted(want):
        a, b = got[c][go], want[c][wo]
        if c in ints:
            if not np.array_equal(a, b):
                fail(f"Q{q}: column {c} differs from the CPU run")
        else:
            if not np.all(np.isfinite(a)):
                fail(f"Q{q}: column {c} has non-finite values")
            if not np.allclose(a, b, rtol=2e-3, atol=1e-2):
                fail(f"Q{q}: column {c} differs from the CPU run: {a} vs {b}")


def run_main_path(torch, data):
    """Q6 and Q1 through the port's Session on the card, each against the
    same plan on the CPU; returns the launch counts of each query's timed
    run, the card's session and the catalog."""
    from repro_torch.core.session import Catalog, Session
    from repro_torch.kernels import ops
    from repro_torch.tpch import queries, schema

    catalog = Catalog.from_numpy(
        data, schema.SCHEMAS, {n: (k,) for n, k in schema.PRIMARY_KEYS.items()})
    rows = len(data["lineitem"]["l_orderkey"])
    gpu = Session(catalog, device="cuda", batch_rows=_MAIN_ROWS)
    cpu = Session(catalog, device="cpu", batch_rows=_MAIN_ROWS)
    morsels = math.ceil(rows / _MAIN_ROWS)
    calls = 2 * morsels - 1      # one _aggregate per morsel, one per merge
    expect = {6: {"fused_morsel_program": morsels, "segmented_sum": 0,
                  "segmented_int_sum": 0},
              1: {"fused_morsel_program": morsels, "segmented_sum": 7 * calls,
                  "segmented_int_sum": 4 * calls}}
    launches = {}
    for q in (6, 1):
        plan = queries.QUERIES[q](catalog)
        gpu.execute(plan)                       # warm: allocator, streams
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = gpu.execute(plan)
        torch.cuda.synchronize()
        gpu_s = [time.perf_counter() - t0]
        counts = ops.launch_counts()
        stats = gpu.executor_stats()
        for _ in range(2):                      # two more timed runs
            t0 = time.perf_counter()
            gpu.execute(plan)
            torch.cuda.synchronize()
            gpu_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = cpu.execute(plan)
        cpu_s = time.perf_counter() - t0
        compare(q, got, want)
        print(f"Q{q} SF {_SF}: gpu {[round(t, 4) for t in gpu_s]} s, "
              f"cpu {cpu_s:.4f} s, rows "
              f"{len(next(iter(got.values())))}, launches {counts}, "
              f"kernel_dispatch {stats['kernel_dispatch']}", flush=True)
        if counts != expect[q]:
            fail(f"Q{q}: launches {counts}, expected {expect[q]}")
        launches[q] = counts
    for k in ops.KERNELS:
        if not any(c[k] for c in launches.values()):
            fail(f"kernel {k} was not launched by the main path")
    return launches, gpu, catalog


_PORT_KERNELS = ("segmented_sum_kernel", "fused_morsel_kernel")


def _device_events(prof):
    """(name, count, device microseconds) of the device-side events (kernels,
    copies, fills) in a profile; CPU-side operator rows are left out, since
    their device time repeats that of the kernels they launched."""
    from torch.autograd import DeviceType
    rows = [[e.key, e.count, e.self_device_time_total]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


def _host_events(prof, top: int = 15):
    """(name, count, self host microseconds) of the busiest host-side rows:
    torch operators and CUDA runtime calls."""
    from torch.autograd import DeviceType
    rows = [[e.key, e.count, e.self_cpu_time_total]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def profile_kernels(torch, launchers, reps: int = 20):
    """Device milliseconds per launch of each kernel at the main path's
    shapes, from ``torch.profiler`` (launch overhead on the host excluded)."""
    from torch.profiler import ProfilerActivity, profile
    symbol = {"segmented_sum": "segmented_sum_kernel<float",
              "segmented_int_sum": "segmented_sum_kernel<int",
              "fused": "fused_morsel_kernel"}
    out = {}
    for name, fn in launchers.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        key = symbol["fused" if name.startswith("fused") else name]
        hits = [r for r in _device_events(prof) if key in r[0]]
        if not hits or sum(r[1] for r in hits) != reps:
            fail(f"profile of {name}: no kernel events matching {key!r}")
        out[name] = sum(r[2] for r in hits) / reps / 1e3
    print(f"device_ms per launch: {json.dumps(out)}", flush=True)
    return out


def profile_main_path(torch, gpu, catalog, out_dir):
    """One profiled warm run of Q6 and of Q1 (``torch.profiler``): device
    time by kernel, device busy time and idle share of the wall time. The
    profiler's own overhead lengthens the wall time it is divided by."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.tpch import queries

    os.makedirs(out_dir, exist_ok=True)
    for q in (6, 1):
        plan = queries.QUERIES[q](catalog)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gpu.execute(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = _device_events(prof)
        busy_us = sum(r[2] for r in rows)
        h2d = [r for r in rows if r[0].startswith("Memcpy HtoD")]
        port = [r for r in rows if any(k in r[0] for k in _PORT_KERNELS)]
        kernels = [r for r in rows if not r[0].startswith("Mem")]
        summary = {"query": q, "wall_s": wall, "device_busy_us": busy_us,
                   "idle_share": 1.0 - busy_us / (wall * 1e6),
                   "h2d_us": sum(r[2] for r in h2d),
                   "h2d_copies": sum(r[1] for r in h2d),
                   "kernel_launches": sum(r[1] for r in kernels),
                   "port_kernels_us": sum(r[2] for r in port),
                   "other_kernels_us": (sum(r[2] for r in kernels)
                                        - sum(r[2] for r in port)),
                   "by_kernel": rows, "host_top": _host_events(prof)}
        with open(os.path.join(out_dir, f"profile_q{q}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_q{q}.json"))
        print(json.dumps({"profile": dict(summary, by_kernel=rows[:8],
                                          host_top=summary["host_top"][:8])}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile Q6 and Q1 and write the summaries and "
                         "traces into DIR")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail("src/repro_torch is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from repro_torch.core import fused
    from repro_torch.core.table import TorchTable
    from repro_torch.kernels import build
    from repro_torch.kernels import segmented_agg as seg
    from repro_torch.tpch import dbgen, queries

    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}"
          f" memory rate {rate:.3g} B/s", flush=True)

    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {json.dumps(secs)} total {time.perf_counter() - t0:.3f} s",
          flush=True)

    t0 = time.perf_counter()
    data = dbgen.generate(_SF)
    lineitem = data["lineitem"]
    n = len(lineitem["l_orderkey"])
    print(f"dbgen SF {_SF}: lineitem {n} rows in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    rows_out, launchers = check_segmented(torch, seg, rate, _MAIN_ROWS)
    # the fused kernel on one main-path morsel of real lineitem rows
    n = min(n, _MAIN_ROWS)
    morsel = TorchTable.from_numpy({c: v[:n] for c, v in lineitem.items()},
                                   dbgen.S.LINEITEM, capacity=_MAIN_ROWS,
                                   device="cuda")
    fused_rows, fused_launchers = check_fused(torch, fused, queries, morsel,
                                              rate)
    rows_out += fused_rows
    launchers.update(fused_launchers)

    launches, gpu, catalog = run_main_path(torch, data)
    if args.profile:
        device_ms = profile_kernels(torch, launchers)
        for r in rows_out:
            r["device_ms"] = device_ms[r["name"]]
        profile_main_path(torch, gpu, catalog, args.profile)
    for r in rows_out:
        key, _, q = r["name"].partition("[Q")
        per_query = [launches[int(q[:-1])]] if q else launches.values()
        r["launches"] = sum(c[key] for c in per_query)
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
