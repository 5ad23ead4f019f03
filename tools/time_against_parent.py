#!/usr/bin/env python3
"""Time the attention kernels and ``build_table`` against an earlier
version of their CUDA sources, in one process on one card.

Run from the repository root on a machine with the card::

    mkdir -p build/parent
    for f in flash_attention hash_table; do
        git show <commit>:src/repro_torch/kernels/csrc/$f.cu \\
            > build/parent/$f.cu
    done
    python3 tools/time_against_parent.py build/parent

The earlier sources are built with nvcc (the port's flags) into a temporary
directory and called through ctypes with the C signatures they had at
``5e32784``: ``flash_attention_run(q, k, v, o, bh, s, d, dtype, causal,
scale, scratch, scratch_bytes, stream)`` with its
``flash_attention_scratch_bytes(bh, s, d, dtype)``, and the round build
``hash_table_build(keys, vals, placed, n, table_size, empty_key, tk, tv,
winner, unplaced, stream)``. The current ones go through the port's
wrappers. Both sources of each pair are also compiled with ``-Xptxas
-v``, and each kernel's registers and spills are printed.

Inputs: every case of phase 9 of ``chip_smoke.py`` (its shapes and seeds;
float32 and bfloat16), the largest ``build_table`` call of TPC-H Q3 and of
Q10 at SF 1 as the card's ``Session`` gives them, and ``chip_smoke.py``'s
duplicate-key build. Each pair is timed in turns, earlier, current,
current, earlier, with CUDA events over warm runs, then once each under
``torch.profiler`` for device time; the two outputs are compared (max
|current - earlier| for attention; the tables must be equal). Prints one
JSON line per input, then the card line.
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
_SOURCES = ("flash_attention", "hash_table")


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
    for name in _SOURCES:
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
    name = re.search(r"attn_(?:f32|tf32x3|mma|wgmma|combine)_kernel"
                     r"|[a-z_]+_kernel", mangled)
    width = re.search(r"Li(\d+)E", mangled)
    kind = ("Bf16" if "Bf16" in mangled else "F16" if "F16" in mangled
            else "F32Out" if "F32Out" in mangled else "")
    args = ", ".join(a for a in (kind, width and width.group(1)) if a)
    return (name.group(0) if name else mangled) + (f"<{args}>" if args else "")


def captured_builds(torch):
    """The largest ``build_table`` call of Q3 and of Q10 at SF 1 on the
    card: {"Q3": (keys, vals, table_size, empty_key, valid), ...}."""
    from repro_torch.core.session import Catalog, Session
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.tpch import dbgen, queries, schema
    data = dbgen.generate(cs._SF)
    catalog = Catalog.from_numpy(data, schema.SCHEMAS, {
        t: (k,) for t, k in schema.PRIMARY_KEYS.items()})
    calls = []
    orig = hp.build_table

    def grab(keys, vals, table_size, empty_key=-1, valid=None):
        calls.append((now[0], (keys.clone(), vals.clone(), table_size,
                               empty_key,
                               None if valid is None else valid.clone())))
        return orig(keys, vals, table_size, empty_key, valid)

    now = [0]
    hp.build_table = grab
    try:
        gpu = Session(catalog, device="cuda", batch_rows=cs._MAIN_ROWS)
        for q in (3, 10):
            now[0] = q
            gpu.execute(queries.build_query(q, catalog))
    finally:
        hp.build_table = orig
    torch.cuda.synchronize()
    return {f"Q{q}": max((a for w, a in calls if w == q), key=lambda a: a[2])
            for q in (3, 10)}


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


def time_attention(torch, fa, lib):
    run = lib.flash_attention_run
    run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    run.restype = ctypes.c_int
    nbytes_of = lib.flash_attention_scratch_bytes
    nbytes_of.argtypes = [ctypes.c_int] * 4
    nbytes_of.restype = ctypes.c_longlong
    dtypes = {"float32": 0, "bfloat16": 1}
    for i, (case, shape, dtype, causal, _, _) in enumerate(cs._ATTN_CASES):
        q, k, v = cs._attn_inputs(torch, shape, dtype, cs._ATTN_SEED + i)
        b, h, s, d = shape
        earlier_out = torch.empty_like(q)
        nbytes = nbytes_of(b * h, s, d, dtypes[dtype])
        scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              device="cuda")

        def earlier(q=q, k=k, v=v, o=earlier_out, c=causal, dt=dtype):
            rc = run(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     b * h, s, d, dtypes[dt], int(c), d ** -0.5,
                     scratch.data_ptr(), nbytes,
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
        del q, k, v, got, earlier_out, scratch


def time_builds(torch, hp, lib):
    build = lib.hash_table_build
    build.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    build.restype = ctypes.c_int
    inputs = captured_builds(torch)
    gen = torch.Generator(device="cuda").manual_seed(13)
    inputs["duplicates"] = cs._build_case(torch, hp, "duplicates", gen)
    for case, (keys, vals, t, empty, valid) in inputs.items():
        n = keys.shape[0]

        def earlier(keys=keys, vals=vals, t=t, empty=empty, valid=valid,
                    n=n):
            tk = torch.full((t,), empty, dtype=torch.int32, device="cuda")
            tv = torch.zeros(t, dtype=torch.int32, device="cuda")
            placed = (torch.zeros(n, dtype=torch.uint8, device="cuda")
                      if valid is None else (~valid).to(torch.uint8))
            winner = torch.full((t,), 2 ** 31 - 1, dtype=torch.int32,
                                device="cuda")
            unplaced = torch.zeros(1, dtype=torch.int32, device="cuda")
            rc = build(keys.data_ptr(), vals.data_ptr(), placed.data_ptr(), n,
                       t, empty, tk.data_ptr(), tv.data_ptr(),
                       winner.data_ptr(), unplaced.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if rc:
                cs.fail(f"earlier build_table: CUDA error {rc}")
            return tk, tv

        def current(a=(keys, vals, t, empty, valid)):
            return hp.build_table(*a)

        e, c = earlier(), current()
        torch.cuda.synchronize()
        if not (torch.equal(e[0], c[0]) and torch.equal(e[1], c[1])):
            cs.fail(f"build_table {case}: the two versions differ")
        times = in_turns(torch, {"earlier": earlier, "current": current}, 10)
        print(json.dumps({
            "case": f"build_table[{case}]", "rows": n,
            "valid": n if valid is None else int(valid.sum()), "slots": t,
            "rounds": cs._rounds(torch, hp, c[0]),
            "earlier_ms": times["earlier"], "current_ms": times["current"],
            "earlier_device_ms": device_ms(torch, earlier, 5),
            "current_device_ms": device_ms(torch, current, 5),
            "equal": True}), flush=True)


def main() -> None:
    if len(sys.argv) != 2:
        cs.fail("usage: tools/time_against_parent.py DIR (the earlier "
                "flash_attention.cu and hash_table.cu)")
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from repro_torch.kernels import build
    from repro_torch.kernels import hash_probe as hp
    # the module (the package's attribute of that name is the function)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    card = cs.card_line()
    print(card, flush=True)
    build.build_all()
    out = Path(tempfile.mkdtemp(prefix="parent_kernels_"))
    libs = compile_all(Path(sys.argv[1]), out)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        time_attention(torch, fa, libs["flash_attention"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    time_builds(torch, hp, libs["hash_table"])
    print(card, flush=True)


if __name__ == "__main__":
    main()
