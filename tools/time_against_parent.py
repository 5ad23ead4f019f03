#!/usr/bin/env python3
"""Time the 16-bit attention kernels and ``block_prefix_sum`` against an
earlier version of their CUDA sources, in one process on one card.

Run from the repository root on a machine with the card::

    mkdir -p build/parent
    for f in flash_attention block_prefix_sum; do
        git show <commit>:src/repro_torch/kernels/csrc/$f.cu \\
            > build/parent/$f.cu
    done
    python3 tools/time_against_parent.py build/parent

The earlier sources are built with nvcc (the port's flags) into a temporary
directory and called through ctypes with the C signatures they had before
the split over K and the one-pass scan: ``flash_attention_run(q, k, v, o,
bh, s, d, dtype, causal, scale, stream)`` and ``block_prefix_sum_run(mask,
n, pos, total, scratch, stream)`` with one int32 of scratch per 1024 rows.
The current ones go through the port's wrappers. Both sources of each pair
are also compiled with ``-Xptxas -v``, and each kernel's registers and
spills are printed.

Inputs: the bfloat16 cases of phase 9 of ``chip_smoke.py`` (its shapes and
seeds), and the first compaction mask of TPC-H Q9 at SF 1 as the card's
``Session`` gives it. Each pair is timed in turns, earlier, current,
current, earlier, with CUDA events over warm runs, then once each under
``torch.profiler`` for device time; the two outputs are compared (max
|current - earlier|; the prefix sums must be equal). Prints one JSON line
per input, then the card line.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def compile_all(parent: Path, out: Path):
    """Build the earlier sources into ``out`` and compile both versions of
    each with ``-Xptxas -v``, all nvcc processes at once; returns the
    loaded earlier libraries and prints each kernel's registers."""
    from repro_torch.kernels import build
    nvcc = build.nvcc_path()
    jobs = {}
    for name in ("flash_attention", "block_prefix_sum"):
        for who, src in (("earlier", parent / f"{name}.cu"),
                         ("current", build.CSRC / f"{name}.cu")):
            lib = out / f"lib{name}-{who}.so"
            cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(build.CSRC), "-o", str(lib), str(src)]
            jobs[(name, who)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), lib)
    libs = {}
    entry = re.compile(r"Compiling entry function '(\S+)'")
    for (name, who), (proc, lib) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc {who} {name}.cu:\n{err}")
        kernel = None
        for line in err.splitlines():
            m = entry.search(line)
            if m:
                kernel = m.group(1)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {who} {_label(kernel)}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        if who == "earlier":
            libs[name] = ctypes.CDLL(str(lib))
    return libs


def _label(mangled: str) -> str:
    """``name<type, DP>`` of a mangled kernel symbol (the lengths that
    prefix each mangled name are digits, so a name of letters starts after
    one)."""
    name = re.search(r"attn_(?:f32|mma|wgmma|combine)_kernel|[a-z_]+_kernel",
                     mangled)
    width = re.search(r"Li(\d+)E", mangled)
    kind = "Bf16" if "Bf16" in mangled else "F16" if "F16" in mangled else ""
    args = ", ".join(a for a in (kind, width and width.group(1)) if a)
    return (name.group(0) if name else mangled) + (f"<{args}>" if args else "")


def q9_mask(torch):
    """The first mask that Q9 at SF 1 hands ``block_prefix_sum`` on the
    card."""
    from repro_torch.core import table as table_mod
    from repro_torch.core.session import Catalog, Session
    from repro_torch.tpch import dbgen, queries, schema
    data = dbgen.generate(cs._SF)
    catalog = Catalog.from_numpy(data, schema.SCHEMAS, {
        t: (k,) for t, k in schema.PRIMARY_KEYS.items()})
    masks = []
    orig = table_mod.block_prefix_sum

    def grab(mask):
        if not masks:
            masks.append(mask.clone())
        return orig(mask)

    table_mod.block_prefix_sum = grab
    try:
        Session(catalog, device="cuda", batch_rows=cs._MAIN_ROWS).execute(
            queries.build_query(9, catalog))
    finally:
        table_mod.block_prefix_sum = orig
    torch.cuda.synchronize()
    return masks[0]


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device milliseconds a call, all device events summed
    (``torch.profiler``; a profile without them is taken again, at most
    twice)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = cs._device_events(prof)
        if events:
            return sum(r[2] for r in events) / reps / 1e3
    cs.fail("no device events in three profiles")


def in_turns(torch, fns, reps):
    """CUDA-event ms of each of ``fns`` ("earlier", "current"), timed in
    turns earlier, current, current, earlier."""
    out = {"earlier": [], "current": []}
    for who in ("earlier", "current", "current", "earlier"):
        out[who].append(cs.time_ms(torch, fns[who], reps=reps))
    return out


def main() -> None:
    if len(sys.argv) != 2:
        cs.fail("usage: tools/time_against_parent.py DIR (the earlier "
                "flash_attention.cu and block_prefix_sum.cu)")
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from repro_torch.kernels import block_prefix_sum as bps
    from repro_torch.kernels import build
    # the module (the package's attribute of that name is the function)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    card = cs.card_line()
    print(card, flush=True)
    build.build_all()
    out = Path(tempfile.mkdtemp(prefix="parent_kernels_"))
    libs = compile_all(Path(sys.argv[1]), out)

    run = libs["flash_attention"].flash_attention_run
    run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    run.restype = ctypes.c_int
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (case, shape, dtype, causal, _, _) in enumerate(cs._ATTN_CASES):
        if dtype == "float32":
            continue
        q, k, v = cs._attn_inputs(torch, shape, dtype, cs._ATTN_SEED + i)
        b, h, s, d = shape
        earlier_out = torch.empty_like(q)

        def earlier(q=q, k=k, v=v, o=earlier_out, c=causal):
            rc = run(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     b * h, s, d, 1, int(c), d ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if rc:
                cs.fail(f"earlier flash_attention: CUDA error {rc}")

        def current(q=q, k=k, v=v, c=causal):
            return fa.flash_attention(q, k, v, causal=c)

        earlier()
        got = current()
        torch.cuda.synchronize()
        diff = float((got.float() - earlier_out.float()).abs().max())
        big = s > 8192
        times = in_turns(torch, {"earlier": earlier, "current": current},
                         5 if big else 20)
        print(json.dumps({
            "case": f"flash_attention[{case}]", "shape": list(shape),
            "earlier_ms": times["earlier"], "current_ms": times["current"],
            "earlier_device_ms": device_ms(torch, earlier, 3 if big else 10),
            "current_device_ms": device_ms(torch, current, 3 if big else 10),
            "max_abs_diff": diff}), flush=True)
        del q, k, v, got, earlier_out
    torch.backends.cuda.matmul.allow_tf32 = old_tf32

    scan = libs["block_prefix_sum"].block_prefix_sum_run
    scan.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 4
    scan.restype = ctypes.c_int
    mask = q9_mask(torch)
    n = mask.shape[0]

    def earlier_scan():
        pos = torch.empty(n, dtype=torch.int32, device="cuda")
        total = torch.empty((), dtype=torch.int32, device="cuda")
        scratch = torch.empty(-(-n // 1024), dtype=torch.int32,
                              device="cuda")
        rc = scan(mask.data_ptr(), n, pos.data_ptr(), total.data_ptr(),
                  scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"earlier block_prefix_sum: CUDA error {rc}")
        return pos, total

    def current_scan():
        return bps.block_prefix_sum(mask)

    (p0, t0), (p1, t1) = earlier_scan(), current_scan()
    torch.cuda.synchronize()
    if not (torch.equal(p0, p1) and torch.equal(t0, t1)):
        cs.fail("block_prefix_sum: the two versions differ on Q9's mask")
    times = in_turns(torch, {"earlier": earlier_scan,
                             "current": current_scan}, 50)
    print(json.dumps({
        "case": "block_prefix_sum[Q9]", "rows": n, "set": int(t1),
        "earlier_ms": times["earlier"], "current_ms": times["current"],
        "earlier_device_ms": device_ms(torch, earlier_scan, 20),
        "current_device_ms": device_ms(torch, current_scan, 20),
        "equal": True}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
