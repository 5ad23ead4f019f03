#!/usr/bin/env python3
"""Time the attention kernels, ``build_table``, the fused kernels, the
segmented sums and min/max, the standalone and expansion probes and the
exchange's metadata phase against an earlier version of their CUDA
sources, in one process on one card.

Run from the repository root on a machine with the card::

    mkdir -p build/parent
    for f in segmented_agg.cu; do
        git show <commit>:src/repro_torch/kernels/csrc/$f > build/parent/$f
    done
    python3 tools/time_against_parent.py build/parent

Each earlier source found in DIR (``flash_attention.cu``, ``hash_table.cu``,
``fused_morsel.cu``, ``fused_batch.cu``, ``segmented_agg.cu``,
``radix_histogram.cu``) is timed; the others are skipped.
The earlier sources are built with nvcc (the port's flags, DIR's headers
before the current ones) into a temporary directory and called through
ctypes with the C signatures they had at ``28729f2``:
``flash_attention_run(q, k, v, o, bh, s, d, dtype, causal, scale,
scratch, scratch_bytes, stream)`` with its
``flash_attention_scratch_bytes(bh, s, d, dtype)``, the round build
``hash_table_build(keys, vals, placed, n, table_size, empty_key, tk, tv,
winner, unplaced, stream)``, and the fused kernels' ``fused_morsel_run``
and ``fused_batch_run``, which took the program as ``lower_registers``
gives it (``prog, n_instr`` in place of the packed plan), and
``segmented_sum_f32`` / ``segmented_sum_i32(gids, vals, n, num_groups,
out, stream)``, unchanged since then; a ``hash_table.cu`` with
``hash_table_build_scratch_bytes`` (``456033b`` on) is built through
the fixed passes' signature instead. ``hash_table_probe``,
``hash_table_probe_multi``, ``segmented_minmax_f32`` / ``_i32`` and
``radix_histogram_run`` have the signatures of
``hash_probe._PROBE_ARGTYPES``, ``_PROBE_MULTI_ARGTYPES``,
``segmented_agg._MINMAX_ARGTYPES`` and ``radix_histogram._ARGTYPES``,
each called behind the earlier wrapper's steps. The current ones
go through the port's wrappers. Both sources of each pair are also
compiled with ``-Xptxas -v``, and each kernel's registers, stack frame and
spills are printed.

Inputs: every case of phase 9 of ``chip_smoke.py`` (its shapes and seeds;
float32 and bfloat16), the largest ``build_table`` call of TPC-H Q3 and of
Q10 at SF 1 as the card's ``Session`` gives them, ``chip_smoke.py``'s
duplicate-key build, and the fused cases of ``chip_smoke.py``: Q1's and
Q6's stages on the first lineitem morsel, Q22's ``PrefixCode`` stages and
the first lineitem morsel of the Q3 and Q10 probes as a run at SF 1 gives
them, the three serving batch programs at 32 lanes, and the segmented
sums' calls of ``chip_smoke.py``'s phase 3 (Q1's first call of each at G =
16, Q3's first part and first merge and Q17's first int merge at SF 1, the
stacked serving call, and the synthetic sorted G = 16 and unsorted G =
4096), and with ``hash_table.cu``, ``segmented_agg.cu`` or
``radix_histogram.cu`` every standalone probe, expansion probe and
``segmented_minmax`` call and every repartition of one run of the 22
queries at W = 1 and W = 4 (``chip_smoke.capture_calls``,
``capture_workers``, taken before any profile; the probes and expansion
probes each launched once in profiles of up to 100 calls, each min/max
call profiled alone with every device event of the call, in turns; a
line a call with its shape, the sums at each W and both wrappers' host
µs), the earlier metadata phase being the
exchange's former torch hash, bins and ``torch.cat`` before the earlier
histogram. Each pair is timed in turns, earlier, current, current, earlier,
with CUDA events over warm runs, then once each under ``torch.profiler``
for device time (the fused and segmented cases: their kernels' events
only; the segmented kernels also alone, on an output zeroed once, with no
fill before each call); the two outputs are compared (max |current -
earlier| for attention; the tables, the fused outputs and the int sums
must be equal, the float sums within twice the tolerance of
``chip_smoke._seg_check`` of each other). Prints one JSON line per input,
then the card line.
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
_SOURCES = ("flash_attention", "hash_table", "fused_morsel",
            "fused_batch", "segmented_agg", "radix_histogram")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def compile_all(parent: Path, out: Path):
    """Build the earlier sources found in ``parent`` into ``out`` and
    compile both versions of each with ``-Xptxas -v``, all nvcc processes
    at once; returns the loaded earlier libraries and prints each kernel's
    registers, stack frame and spills."""
    from repro_torch.kernels import build
    nvcc = build.nvcc_path()
    jobs = {}
    for name in _SOURCES:
        if not (parent / f"{name}.cu").exists():
            continue
        for who, src, inc in (("earlier", parent / f"{name}.cu", [parent]),
                              ("current", build.CSRC / f"{name}.cu", [])):
            lib = out / f"lib{name}-{who}.so"
            cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v",
                   *[x for d in inc + [build.CSRC] for x in ("-I", str(d))],
                   "-o", str(lib), str(src)]
            jobs[(name, who)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), lib)
    libs = {}
    for (name, who), (proc, lib) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc {who} {name}.cu:\n{err}")
        for kernel, info in cs.ptxas_report(err).items():
            print(f"ptxas {who} {_label(kernel)}: {json.dumps(info)}",
                  flush=True)
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
    sums = re.search(r"segmented_sum_kernelI([fi])Lb([01])E", mangled)
    if sums:
        return (f"segmented_sum_kernel<{'float' if sums.group(1) == 'f' else 'int'}"
                f", {'shared' if sums.group(2) == '1' else 'global'}>")
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


def device_ms(torch, fn, reps: int = 10, key: str = "") -> float:
    """Device milliseconds a call, the device events whose name holds
    ``key`` summed (all of them by default; ``torch.profiler`` through
    ``chip_smoke._profiled``; a profile without them is taken again, at
    most twice)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        prof, _ = cs._profiled(torch, lambda: [fn() for _ in range(reps)])
        events = [r for r in cs._device_events(prof) if key in r[0]]
        if events:
            return sum(r[2] for r in events) / reps / 1e3
    cs.fail(f"no device events{' of ' + key if key else ''} in three "
            "profiles")


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


def _earlier_passes(torch, hp, lib):
    """The earlier ``hash_table_build`` of the fixed passes (``456033b``
    on: the signature of ``hash_probe._BUILD_ARGTYPES``, scratch from its
    ``hash_table_build_scratch_bytes``) -> a build function, or None for a
    source from before them."""
    try:
        nbytes_of = lib.hash_table_build_scratch_bytes
    except AttributeError:
        return None
    nbytes_of.argtypes, nbytes_of.restype = [ctypes.c_longlong], \
        ctypes.c_longlong
    build = lib.hash_table_build
    build.argtypes, build.restype = hp._BUILD_ARGTYPES, ctypes.c_int

    def run(keys, vals, t, empty, valid):
        n = keys.shape[0]
        tk = torch.full((t,), empty, dtype=torch.int32, device="cuda")
        tv = torch.zeros(t, dtype=torch.int32, device="cuda")
        nbytes = nbytes_of(n)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        rc = build(keys.data_ptr(), vals.data_ptr(),
                   None if valid is None else valid.data_ptr(), n, t, empty,
                   tk.data_ptr(), tv.data_ptr(), scratch.data_ptr(), nbytes,
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"earlier build_table: CUDA error {rc}")
        return tk, tv
    return run


def time_builds(torch, hp, lib):
    passes = _earlier_passes(torch, hp, lib)
    build = lib.hash_table_build if passes is None else None
    if build is not None:
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
            if passes is not None and n < t:
                return passes(keys, vals, t, empty, valid)
            if passes is not None:
                return hp.build_table(keys, vals, t, empty, valid)
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


def _ptrs(ctypes_type, tensors):
    return (ctypes_type * max(len(tensors), 1))(*tensors)


def earlier_morsel(torch, fused, lib, table, stages, probe):
    """A launch of the earlier ``fused_morsel_run`` on the program as
    ``lower_registers`` gives it -> a function returning (out table,
    found, bidx)."""
    run = lib.fused_morsel_run
    run.argtypes, run.restype = fused._ARGTYPES, ctypes.c_int
    raw = fused.lower_registers(
        table, stages, probe_keys=None if probe is None else probe["probe_keys"],
        pack=None if probe is None else probe["pack"],
        empty_key=-1 if probe is None else probe["empty_key"])
    code = raw.code.contiguous()
    n = table.capacity
    ins = [table.columns[c].contiguous() for c in raw.in_names]
    in_ptrs = _ptrs(ctypes.c_uint64, [t.data_ptr() for t in ins])
    in_widths = _ptrs(ctypes.c_int, list(raw.in_widths))
    valid_in = table.validity.contiguous()
    tk = tv = None
    if probe is not None:
        tk, tv = probe["tk"], probe["tv"]
        mp = min(int(probe["max_probes"]), tk.shape[0])

    def call():
        outs = [torch.empty(n, dtype=d, device="cuda") for d in raw.out_dtypes]
        valid_out = torch.empty(n, dtype=torch.bool, device="cuda")
        found = bidx = None
        if probe is not None:
            found = torch.empty(n, dtype=torch.bool, device="cuda")
            bidx = torch.empty(n, dtype=torch.int32, device="cuda")
        rc = run(code.data_ptr(), code.shape[0], in_ptrs, in_widths, len(ins),
                 _ptrs(ctypes.c_uint64, [t.data_ptr() for t in outs]),
                 len(outs), valid_in.data_ptr(), valid_out.data_ptr(), n,
                 None if tk is None else tk.data_ptr(),
                 None if tv is None else tv.data_ptr(),
                 0 if tk is None else tk.shape[0], 0 if tk is None else mp,
                 -1 if probe is None else int(probe["empty_key"]),
                 None if found is None else found.data_ptr(),
                 None if bidx is None else bidx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"earlier fused_morsel_run: CUDA error {rc}")
        return (type(table)(dict(zip(raw.out_names, outs)), valid_out,
                            dict(raw.out_schema)), found, bidx)
    return call


def earlier_batch(torch, fused, lib, table, stages, params, lanes):
    """A launch of the earlier ``fused_batch_run`` (lanes <= 64) on the
    program as ``lower_registers`` gives it -> a function returning
    (stored columns, masks)."""
    run = lib.fused_batch_run
    run.argtypes, run.restype = fused._BATCH_ARGTYPES, ctypes.c_int
    raw = fused.lower_registers(table, stages, batch=True)
    code = raw.code.contiguous()
    n = table.capacity
    ins = [table.columns[c].contiguous() for c in raw.in_names]
    in_ptrs = _ptrs(ctypes.c_uint64, [t.data_ptr() for t in ins])
    in_widths = _ptrs(ctypes.c_int, list(raw.in_widths))
    bits = fused._param_bits(raw, params, lanes, table.device)
    valid_in = table.validity.contiguous()
    stored = [d for d, a in zip(raw.out_dtypes, raw.out_alias) if a is None]

    def call():
        outs = [torch.empty(n, dtype=d, device="cuda") for d in stored]
        masks = torch.empty((lanes, n), dtype=torch.bool, device="cuda")
        rc = run(code.data_ptr(), code.shape[0], in_ptrs, in_widths, len(ins),
                 _ptrs(ctypes.c_uint64, [t.data_ptr() for t in outs]),
                 len(outs), None if bits is None else bits.data_ptr(),
                 len(raw.param_dtypes), lanes, valid_in.data_ptr(),
                 masks.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"earlier fused_batch_run: CUDA error {rc}")
        return outs, masks
    return call


def _fused_inputs(torch, hp, fused):
    """The fused cases: name -> (table, stages, probe or None, program),
    and the serving programs: name -> (table, stages, params)."""
    from repro_torch.core import batch
    from repro_torch.core.builder import QueryBuilder
    from repro_torch.core.expr import col
    from repro_torch.core.session import Catalog
    from repro_torch.core.table import TorchTable
    from repro_torch.tpch import dbgen, queries, schema
    data = dbgen.generate(cs._SF)
    catalog = Catalog.from_numpy(data, schema.SCHEMAS, {
        t: (k,) for t, k in schema.PRIMARY_KEYS.items()})
    li = data["lineitem"]
    n = min(len(li["l_orderkey"]), cs._MAIN_ROWS)
    morsel = TorchTable.from_numpy({c: v[:n] for c, v in li.items()},
                                   dbgen.S.LINEITEM, capacity=cs._MAIN_ROWS,
                                   device="cuda")
    cases = {}
    for q in (1, 6):
        table, stages = cs.fused_case(queries, catalog, morsel, q)
        cases[f"fused_morsel_program[Q{q}]"] = (
            table, stages, None, fused.lower_stages(table, stages))
    calls = cs.capture_calls(torch, hp, fused, catalog)
    c = max(calls["fused_plain"], key=lambda c: c["program"].code.shape[0])
    cases["fused_morsel_program[Q22]"] = (c["table"], c["stages"], None,
                                          c["program"])
    for q in (3, 10):
        c = next(c for c in calls["fused"] if c["q"] == q
                 and c["probe"]["probe_keys"] == ("l_orderkey",))
        cases[f"fused_morsel_probe[Q{q}]"] = (c["table"], c["stages"],
                                              c["probe"], c["program"])
    serving = {}
    keys = data["orders"]["o_orderkey"]
    for shape in cs._SHAPES:
        shapes = [batch.extract_shape(cs.small_query(
            QueryBuilder, col, catalog, keys, shape, j).optimized())
            for j in range(cs._LANES)]
        prog = shapes[0].program
        src = data[prog.table]
        sch = catalog.get(prog.table).schema
        rows = min(len(src[prog.columns[0]]), cs._MAIN_ROWS)
        full = TorchTable.from_numpy(
            {c: src[c][:rows] for c in prog.columns},
            {c: sch[c] for c in prog.columns}, capacity=cs._MAIN_ROWS,
            device="cuda")
        serving[f"fused_batch_program[{shape}]"] = (
            full, prog.pre_stages,
            batch._params(prog, shapes, cs._LANES, full.device))
    return cases, serving


def time_fused(torch, hp, libs):
    """The fused cases, earlier against current, outputs equal."""
    from repro_torch.core import fused
    cases, serving = _fused_inputs(torch, hp, fused)
    if "fused_morsel" in libs:
        for name, (table, stages, probe, program) in cases.items():
            earlier = earlier_morsel(torch, fused, libs["fused_morsel"], table,
                                     stages, probe)

            def current(t=table, st=stages, pr=probe, p=program):
                return fused.fused_morsel_program(t, st, probe=pr, program=p)

            (e, ef, eb), (c, cf, cb) = earlier(), current()
            torch.cuda.synchronize()
            same = (torch.equal(e.validity, c.validity)
                    and all(cs._bits_equal(torch, e.columns[k], c.columns[k])
                            for k in c.column_names)
                    and (probe is None or (torch.equal(ef, cf)
                                           and torch.equal(eb, cb))))
            if not same:
                cs.fail(f"{name}: the two versions differ")
            _print_pair(torch, name, table.capacity, earlier, current,
                        "fused_morsel_kernel")
    if "fused_batch" in libs:
        for name, (table, stages, params) in serving.items():
            earlier = earlier_batch(torch, fused, libs["fused_batch"], table,
                                    stages, params, cs._LANES)
            program = fused.lower_stages(table, stages, batch=True)

            def current(t=table, st=stages, pr=params, p=program):
                return fused.fused_batch_program(t, st, pr, cs._LANES,
                                                 program=p)

            (eo, em), (c, cm) = earlier(), current()
            torch.cuda.synchronize()
            stored = [c.columns[k] for k, a in zip(program.out_names,
                                                  program.out_alias)
                      if a is None]
            if not (torch.equal(em, cm) and all(
                    cs._bits_equal(torch, a, b) for a, b in zip(eo, stored))):
                cs.fail(f"{name}: the two versions differ")
            _print_pair(torch, name, table.capacity, earlier, current,
                        "fused_batch_kernel")


def _print_pair(torch, name, rows, earlier, current, kernel):
    times = in_turns(torch, {"earlier": earlier, "current": current}, 20)
    print(json.dumps({
        "case": name, "rows": rows,
        "earlier_ms": times["earlier"], "current_ms": times["current"],
        "earlier_device_ms": device_ms(torch, earlier, 20, kernel),
        "current_device_ms": device_ms(torch, current, 20, kernel),
        "equal": True}), flush=True)


def _segmented_inputs(torch, seg_calls, catalog, data):
    """The segmented cases: name -> (ids, values, G), from the captured
    calls ``seg_calls``, the stacked serving call and the synthetic
    ones."""
    from repro_torch.core import fused
    cases = {f"{c['kernel']}[{c['case']}]": (c["gids"], c["values"], c["g"])
             for c in seg_calls}
    cases["segmented_sum[stacked]"] = cs.stacked_call(torch, fused, catalog,
                                                      data)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for case in ("sorted G=16", "unsorted G=4096"):
        gids, fv, _, g = cs._seg_inputs(torch, case, gen)
        cases[f"segmented_sum[{case}]"] = (gids, fv, g)
    return cases


def time_segmented(torch, lib, cases):
    """The segmented cases, earlier against current: through the wrappers
    (the current one's zero fill, and the same fill before the earlier
    kernel), then each kernel alone."""
    from repro_torch.kernels import build
    from repro_torch.kernels import segmented_agg as seg
    rate = cs.by_name(cs._MEM_RATE, torch.cuda.get_device_name(0))
    fns = {"segmented_sum": (lib.segmented_sum_f32, seg.segmented_sum),
           "segmented_int_sum": (lib.segmented_sum_i32,
                                 seg.segmented_int_sum)}
    for run, _ in fns.values():
        run.argtypes, run.restype = seg._ARGTYPES, ctypes.c_int
    for name, (gids, vals, g) in cases.items():
        run, kernel = fns[name.partition("[")[0]]

        def earlier(gids=gids, vals=vals, g=g, run=run):
            out = torch.zeros(g, dtype=vals.dtype, device="cuda")
            rc = run(gids.data_ptr(), vals.data_ptr(), gids.shape[0], g,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                cs.fail(f"earlier {name}: CUDA error {rc}")
            return out

        def current(gids=gids, vals=vals, g=g, kernel=kernel):
            return kernel(gids, vals, g)

        e, c = earlier(), current()
        torch.cuda.synchronize()
        if vals.dtype == torch.int32:
            diff, same = float((e != c).sum()), torch.equal(e, c)
        else:
            scale = seg.segmented_sum_plain(gids, vals.abs(), g)
            diff = float((e - c).abs().max())
            same = bool(((e - c).abs() <= 2 * (1e-4 * scale + 1e-6)).all())
        if not same:
            cs.fail(f"{name}: the two versions differ ({diff})")
        bound, _, live = cs.seg_bound_ms(gids, g, rate)
        times = in_turns(torch, {"earlier": earlier, "current": current}, 20)
        # each kernel alone: its C entry point on one output zeroed once,
        # with no fill before each call whose dirty lines the kernel's
        # reads would write back (the sums pile up; only the time is kept)
        out = torch.zeros(g, dtype=vals.dtype, device="cuda")
        symbol = ("segmented_sum_i32" if vals.dtype == torch.int32
                  else "segmented_sum_f32")
        alone = {"earlier": run, "current": build.function(
            seg._LIB, symbol, seg._ARGTYPES, device=gids.device)}
        alone_ms = {who: device_ms(torch, lambda f=f: f(
            gids.data_ptr(), vals.data_ptr(), gids.shape[0], g,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), 20,
            "segmented_sum_kernel") for who, f in alone.items()}
        print(json.dumps({
            "case": name, "rows": gids.shape[0], "live_rows": live,
            "groups": g, "earlier_ms": times["earlier"],
            "current_ms": times["current"],
            "earlier_device_ms": device_ms(torch, earlier, 20,
                                           "segmented_sum_kernel"),
            "current_device_ms": device_ms(torch, current, 20,
                                           "segmented_sum_kernel"),
            "earlier_alone_device_ms": alone_ms["earlier"],
            "current_alone_device_ms": alone_ms["current"],
            "bound_ms": bound, "max_diff": diff}), flush=True)


def _main_path_calls(torch):
    """Every standalone probe, expansion probe and min/max call and every
    repartition of the 22 queries at SF 1 (``chip_smoke.capture_calls`` at
    W = 1, ``capture_workers`` at W = 4): {"probe", "multi", "minmax",
    "repartition": [call, ...]}."""
    from repro_torch.core import fused
    from repro_torch.core.session import Catalog
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.tpch import dbgen, schema
    data = dbgen.generate(cs._SF)
    catalog = Catalog.from_numpy(data, schema.SCHEMAS, {
        t: (k,) for t, k in schema.PRIMARY_KEYS.items()})
    w1 = cs.capture_calls(torch, hp, fused, catalog)
    w4 = cs.capture_workers(torch, hp, fused, catalog)
    calls = {k: w1[k] + w4[k] for k in ("probe", "multi", "minmax")}
    calls["repartition"] = w4["repartition"]
    calls["seg"] = _segmented_inputs(torch, w1["seg"], catalog, data)
    return calls


def time_probes(torch, lib, calls):
    """Every main-path probe call, the earlier ``hash_table_probe`` against
    the current wrapper, outputs equal: the device µs of each call from
    one profile of all of them, in turns (earlier, current, current,
    earlier); prints the sums at each W and each group of calls (one
    query, W and shape), and the wrapper's host µs on the heaviest."""
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ops
    run = lib.hash_table_probe
    run.argtypes, run.restype = hp._PROBE_ARGTYPES, ctypes.c_int

    def earlier_of(c):
        # the earlier wrapper (``344cee8``) step for step, on the earlier
        # entry point: its checks, two allocations, three contiguous
        # copies, the stream object, the launch, the check and the count
        def call(tk=c["tk"], tv=c["tv"], keys=c["keys"], empty=c["empty"],
                 max_probes=c["max_probes"]):
            ops.mark_kernel("probe")
            hp._check_probe_args("hash_probe", tk, tv, keys)
            t = tk.shape[0]
            dev = keys.device
            n = keys.shape[0]
            found = torch.empty(n, dtype=torch.bool, device=dev)
            vals = torch.empty(n, dtype=torch.int32, device=dev)
            tk, tv, keys = tk.contiguous(), tv.contiguous(), keys.contiguous()
            rc = run(tk.data_ptr(), tv.data_ptr(), t, min(max_probes, t),
                     empty, keys.data_ptr(), n, found.data_ptr(),
                     vals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                cs.fail(f"earlier hash_probe: CUDA error {rc}")
            ops.count_launch("hash_probe")
            return found, vals
        return call

    def current_of(c):
        return lambda: hp.hash_probe(c["tk"], c["tv"], c["keys"], c["empty"],
                                     c["max_probes"])

    fns = {"earlier": [earlier_of(c) for c in calls],
           "current": [current_of(c) for c in calls]}
    for c, e, k in zip(calls, fns["earlier"], fns["current"]):
        a, b = e(), k()
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            cs.fail(f"hash_probe Q{c['q']} W={c['w']}: the two versions "
                    "differ")
    us = {"earlier": [], "current": []}
    for who in ("earlier", "current", "current", "earlier"):
        us[who].append(cs.per_call_device_us(torch, fns[who],
                                             ("hash_probe_kernel",)))
    groups = {}
    for i, c in enumerate(calls):
        g = groups.setdefault((c["q"], c["w"], c["tk"].shape[0],
                               c["max_probes"]), [0, [0.0, 0.0], [0.0, 0.0],
                                                  i])
        g[0] += 1
        for who, at in (("earlier", 1), ("current", 2)):
            for k in range(2):
                g[at][k] += us[who][k][i]
    for w in sorted({c["w"] for c in calls}):
        sel = [i for i, c in enumerate(calls) if c["w"] == w]
        print(json.dumps({
            "case": f"hash_probe[W={w}]", "calls": len(sel),
            "earlier_device_us": [sum(u[i] for i in sel)
                                  for u in us["earlier"]],
            "current_device_us": [sum(u[i] for i in sel)
                                  for u in us["current"]]}), flush=True)
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1][0])
    for (q, w, t, mp), (k, e, c, first) in ranked:
        print(json.dumps({
            "case": f"hash_probe[Q{q} W={w}]", "slots": t, "max_probes": mp,
            "keys": calls[first]["keys"].shape[0], "calls": k,
            "earlier_device_us": e, "current_device_us": c}), flush=True)
    first = ranked[0][1][3]
    print(json.dumps({
        "case": "hash_probe host_us", "query": calls[first]["q"],
        "earlier_host_us": cs.host_us(torch, fns["earlier"][first]),
        "current_host_us": cs.host_us(torch, fns["current"][first])}),
        flush=True)


def _print_turns(torch, what, calls, us, shapes, earlier, current):
    """One line a call (its shape, the device µs of each turn), the sums at
    each W, and the host µs of both versions on the heaviest call."""
    for i, c in enumerate(calls):
        print(json.dumps({
            "case": f"{what}[Q{c['q']} W={c['w']}]", **shapes[i],
            "earlier_device_us": [u[i] for u in us["earlier"]],
            "current_device_us": [u[i] for u in us["current"]]}), flush=True)
    for w in sorted({c["w"] for c in calls}):
        sel = [i for i, c in enumerate(calls) if c["w"] == w]
        print(json.dumps({
            "case": f"{what}[W={w}]", "calls": len(sel),
            "bound_us": sum(shapes[i]["bound_us"] for i in sel),
            "earlier_device_us": [sum(u[i] for i in sel)
                                  for u in us["earlier"]],
            "current_device_us": [sum(u[i] for i in sel)
                                  for u in us["current"]]}), flush=True)
    first = max(range(len(calls)), key=lambda i: us["earlier"][0][i])
    print(json.dumps({
        "case": f"{what} host_us", "query": calls[first]["q"],
        "w": calls[first]["w"],
        "earlier_host_us": cs.host_us(torch, earlier[first]),
        "current_host_us": cs.host_us(torch, current[first])}), flush=True)


def time_multi(torch, lib, calls):
    """Every main-path expansion probe, the earlier ``hash_table_probe_multi``
    behind the earlier wrapper's steps against the current wrapper, counts
    and slots equal: each call's device µs from profiles of all of them,
    in turns (earlier, current, current, earlier); a line a call with its
    shape (``chip_smoke.multi_shape``), the sums at each W, and both
    wrappers' host µs on the heaviest call."""
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ops
    rate = cs.by_name(cs._MEM_RATE, torch.cuda.get_device_name(0))
    run = lib.hash_table_probe_multi
    run.argtypes, run.restype = hp._PROBE_MULTI_ARGTYPES, ctypes.c_int

    def earlier_of(c):
        # the earlier wrapper (``c6619de``) step for step: its checks, two
        # allocations, three contiguous copies, the stream object, the
        # launch, the check and the count
        def call(tk=c["tk"], tv=c["tv"], keys=c["keys"], m=c["m"],
                 empty=c["empty"], max_probes=c["max_probes"]):
            ops.mark_kernel("probe")
            hp._check_probe_args("hash_probe_multi", tk, tv, keys)
            if not 1 <= m < 2 ** 16:
                cs.fail(f"hash_probe_multi: max_matches {m} out of range")
            t = tk.shape[0]
            dev = keys.device
            n = keys.shape[0]
            count = torch.empty(n, dtype=torch.int32, device=dev)
            slots = torch.empty((n, m), dtype=torch.int32, device=dev)
            tk, tv, keys = tk.contiguous(), tv.contiguous(), keys.contiguous()
            rc = run(tk.data_ptr(), tv.data_ptr(), t, min(max_probes, t),
                     empty, keys.data_ptr(), n, m, count.data_ptr(),
                     slots.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                cs.fail(f"earlier hash_probe_multi: CUDA error {rc}")
            ops.count_launch("hash_probe_multi")
            return count, slots
        return call

    fns = {"earlier": [earlier_of(c) for c in calls],
           "current": [lambda c=c: hp.hash_probe_multi(*cs._multi_args(c))
                       for c in calls]}
    for c, e, k in zip(calls, fns["earlier"], fns["current"]):
        a, b = e(), k()
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            cs.fail(f"hash_probe_multi Q{c['q']} W={c['w']}: the two "
                    "versions differ")
    us = {"earlier": [], "current": []}
    for who in ("earlier", "current", "current", "earlier"):
        us[who].append(cs.per_call_device_us(torch, fns[who],
                                             ("hash_probe_multi",)))
    shapes = [cs.multi_shape(torch, hp, c, rate) for c in calls]
    _print_turns(torch, "hash_probe_multi", calls, us, shapes,
                 fns["earlier"], fns["current"])


def time_minmax(torch, lib, calls):
    """Every main-path ``segmented_minmax`` call, the earlier entry behind
    the earlier wrapper's steps against the current wrapper, bit for bit
    equal: each call's device µs (every device event of the call: the
    earlier version's fill, kernel and key map-back), in turns; a line a
    call with its shape (``chip_smoke.minmax_shape``), the sums at each W,
    and both wrappers' host µs on the heaviest call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_agg as seg
    rate = cs.by_name(cs._MEM_RATE, torch.cuda.get_device_name(0))
    runs = {torch.float32: lib.segmented_minmax_f32,
            torch.int32: lib.segmented_minmax_i32}
    for run in runs.values():
        run.argtypes, run.restype = seg._MINMAX_ARGTYPES, ctypes.c_int

    def earlier_of(c):
        # the earlier wrapper (``c6619de``) step for step
        def call(gids=c["gids"], vals=c["values"], g=c["g"], kind=c["kind"]):
            if gids.dtype != torch.int32 or vals.dtype not in runs:
                cs.fail("segmented_minmax: dtypes")
            if gids.dim() != 1 or vals.shape != gids.shape:
                cs.fail("segmented_minmax: shapes")
            if vals.device != gids.device or not 0 <= g < 2 ** 31:
                cs.fail("segmented_minmax: devices or groups")
            gids, vals = gids.contiguous(), vals.contiguous()
            out = torch.empty(g, dtype=vals.dtype, device=gids.device)
            rc = runs[vals.dtype](
                gids.data_ptr(), vals.data_ptr(), gids.numel(), g,
                int(kind == "min"), out.data_ptr(),
                torch.cuda.current_stream(gids.device).cuda_stream)
            if rc:
                cs.fail(f"earlier segmented_minmax: CUDA error {rc}")
            ops.count_launch("segmented_minmax")
            return out
        return call

    fns = {"earlier": [earlier_of(c) for c in calls],
           "current": [lambda c=c: seg.segmented_minmax(
               c["gids"], c["values"], c["g"], c["kind"]) for c in calls]}
    for c, e, k in zip(calls, fns["earlier"], fns["current"]):
        a, b = e(), k()
        torch.cuda.synchronize()
        if not cs._bits_equal(torch, a, b):
            cs.fail(f"segmented_minmax Q{c['q']} W={c['w']}: the two "
                    "versions differ")
    us = {"earlier": [], "current": []}
    for who in ("earlier", "current", "current", "earlier"):
        us[who].append([cs.call_device_us(torch, f) for f in fns[who]])
    shapes = [cs.minmax_shape(torch, c, rate) for c in calls]
    _print_turns(torch, "segmented_minmax", calls, us, shapes,
                 fns["earlier"], fns["current"])


def time_partitions(torch, lib, calls):
    """Every repartition's metadata phase, earlier against current, pids
    and counts equal: earlier is the exchange's former torch code (the
    partition hash in int64 torch ops, the bins, a ``torch.cat``) and the
    earlier ``radix_histogram_run``; current is ``partition_histogram``.
    Device µs of every event of each call, in turns; prints each call and
    the sums."""
    from repro_torch.core import relational as rel
    from repro_torch.kernels import radix_histogram as rh
    run = lib.radix_histogram_run
    run.argtypes, run.restype = rh._ARGTYPES, ctypes.c_int

    def earlier(c):
        w = c["w"]
        pids, bins = [], []
        for src, (keys, valid) in enumerate(zip(c["keys"], c["valid"])):
            pid = rel.partition_ids(keys, valid, w)
            pid = torch.where(valid, pid, torch.full_like(pid, w))
            pids.append(pid)
            bins.append(torch.where(pid < w, pid + src * w,
                                    torch.full_like(pid, w * w)))
        ids = torch.cat(bins)
        counts = torch.empty(w * w, dtype=torch.int32, device="cuda")
        rc = run(ids.data_ptr(), ids.shape[0], w * w, counts.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"earlier radix_histogram: CUDA error {rc}")
        return torch.cat(pids), counts.reshape(w, w)

    def current(c):
        return rh.partition_histogram(c["keys"], c["valid"], c["w"])

    total = {"earlier": 0.0, "current": 0.0}
    for c in calls:
        a, b = earlier(c), current(c)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            cs.fail(f"repartition Q{c['q']} {c['names']}: the two versions "
                    "differ")
        us = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            fn = earlier if who == "earlier" else current
            us[who].append(cs.call_device_us(torch, lambda: fn(c)))
        for who in total:
            total[who] += sum(us[who]) / len(us[who])
        print(json.dumps({
            "case": f"partition[Q{c['q']} W={c['w']}]",
            "rows": [v.shape[0] for v in c["valid"]], "keys": c["names"],
            "earlier_device_us": us["earlier"],
            "current_device_us": us["current"]}), flush=True)
    print(json.dumps({"case": "partition[all]", "calls": len(calls),
                      "earlier_device_us": total["earlier"],
                      "current_device_us": total["current"]}), flush=True)


def main() -> None:
    if len(sys.argv) != 2:
        cs.fail("usage: tools/time_against_parent.py DIR (the earlier "
                "sources: flash_attention.cu, hash_table.cu, fused_morsel.cu, "
                "fused_batch.cu with their headers and segmented_agg.cu, any "
                "of them)")
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
    # the main-path captures run sessions (with their prefetch threads)
    # before any profile: a profile taken before such a run makes later
    # profiles lose events
    calls = None
    if {"hash_table", "radix_histogram", "segmented_agg"} & set(libs):
        calls = _main_path_calls(torch)
    if "flash_attention" in libs:
        old_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            time_attention(torch, fa, libs["flash_attention"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old_tf32
    if "hash_table" in libs:
        time_builds(torch, hp, libs["hash_table"])
        time_probes(torch, libs["hash_table"], calls["probe"])
        time_multi(torch, libs["hash_table"], calls["multi"])
    if "segmented_agg" in libs:
        time_segmented(torch, libs["segmented_agg"], calls["seg"])
        time_minmax(torch, libs["segmented_agg"], calls["minmax"])
    if "fused_morsel" in libs or "fused_batch" in libs:
        time_fused(torch, hp, libs)
    if "radix_histogram" in libs:
        time_partitions(torch, libs["radix_histogram"], calls["repartition"])
    print(card, flush=True)


if __name__ == "__main__":
    main()
