"""Shared helpers for the differential tests of the PyTorch port
(``repro_torch``) against the JAX reference (``repro``).

* ``to_port`` translates a reference plan or expression tree, node by node,
  into the port's classes of the same names (every dataclass of the port's
  ``plan``, ``expr`` and ``dtypes``: ``BytesMatch``, ``Year`` and
  ``PrefixCode`` too).
* ``emulate`` runs a lowered fused-kernel program (``core.fused.Program``)
  on the CPU, one instruction at a time over whole columns, with the exact
  32-bit semantics of ``kernels/csrc/fused_morsel.cu``, so the lowering is
  tested where the CUDA kernel cannot run; ``emulate_probe`` runs a
  program that ends in the join probe, with the linear probe of
  ``kernels/csrc/hash_probe.cuh`` written in numpy; ``emulate_batch``
  runs a batch program (``lower_stages(..., batch=True)``) as
  ``kernels/csrc/fused_batch.cu`` does: PARAM reads the lane's parameter,
  each LOOP ... LFILTER body runs once per lane, and every register the
  body wrote is dropped after the loop (the kernel skips the body for dead
  lanes, so nothing may read one).
* ``emulate_tiles`` runs a program's ``plan`` (``fused.assign_slots``) as
  the tile kernels of ``kernels/csrc/fused_interp.cuh`` do: the tiles of
  1024 rows, four a thread, the load stage and the computed slots as bytes
  at the plan's offsets, zero fill past n, the uniform table a lane, the
  per-warp lane skip (a skipped body's slots poisoned), and stores masked
  to the rows below n.
* All three run YEAR with the kernel's arithmetic (``year_numpy``) and
  BYTESMATCH by walking the pattern record of the program's pool over each
  row as the kernel does (``match_numpy``), so a test against the plain
  version holds the kernel's semantics to the reference's.
* ``emulate_partition`` is the exchange's metadata pass of
  ``kernels/csrc/radix_histogram.cu`` (``partition_histogram_run`` and its
  kernel) on CPU tensors at their real addresses: each source's chunk grid
  on the first int32 key column's 16-byte boundaries (else the pids'), the
  arrays it loads whole checked to be aligned, every row covered once, no
  key read for a chunk of dead rows, and the hash in uint32.
* ``emulate_segmented`` runs the segmented reductions of
  ``kernels/csrc/segmented_agg.cu`` (``reduce_rows``, one template over
  the combining operation) step by step: the 4-row chunks on the ids'
  16-byte grid, no value load for a dead chunk, warp steps, ranges dealt
  to the warps, the folds and joins of runs with the shuffles' semantics,
  the shared partials, and the output's updates (``SumOp``'s adds, or
  ``MinMaxOp``'s sign-split integer atomics on the float bits), applied in
  a shuffled order on request.
* ``seeded_columns`` makes a small morsel's worth of columns from a seed.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import dtypes as port_dtypes
from repro_torch.core import expr as port_expr
from repro_torch.core import fused as port_fused
from repro_torch.core import plan as port_plan
from repro_torch.core.table import TorchTable

_PORT_CLASSES = {
    name: obj
    for mod in (port_plan, port_expr, port_dtypes)
    for name, obj in vars(mod).items()
    if isinstance(obj, type) and dataclasses.is_dataclass(obj)
}


def to_port(v):
    """Reference plan node / Expr / DType (and containers of them) -> the
    port's object of the same class name and fields."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = _PORT_CLASSES[type(v).__name__]
        return cls(**{f.name: to_port(getattr(v, f.name))
                      for f in dataclasses.fields(v)})
    if isinstance(v, list):
        return [to_port(x) for x in v]
    if isinstance(v, tuple):
        return tuple(to_port(x) for x in v)
    if isinstance(v, dict):
        return {k: to_port(x) for k, x in v.items()}
    return v


def port_schema(ref_schema: dict) -> dict:
    """Reference ``name -> DType`` schema -> the port's."""
    return {n: to_port(d) for n, d in ref_schema.items()}


def seeded_columns(n: int, seed: int = 0) -> dict:
    """Columns of every physical kind the fused kernel takes, with the
    edge values a morsel can hold (INT32_MIN/MAX, -0.0, inf, NaN)."""
    rng = np.random.default_rng(seed)
    i = rng.integers(-50, 50, n).astype(np.int32)
    i[:4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1]
    j = rng.integers(-5, 6, n).astype(np.int32)
    f = rng.normal(0, 10, n).astype(np.float32)
    f[:4] = [-0.0, np.inf, np.nan, 0.5]
    g = rng.normal(0, 1, n).astype(np.float32)
    b = rng.random(n) < 0.5
    d = rng.integers(8000, 10000, n).astype(np.int32)
    return {"i": i, "j": j, "f": f, "g": g, "b": b, "d": d}


def stage_cases(col, lit, date_lit) -> dict:
    """Runs of FilterProject stages over ``seeded_columns`` that touch every
    opcode of the fused kernel, every promotion rule and every edge value;
    built with either package's ``col``/``lit``/``date_lit``."""
    return {
        "arith_i32_wraps": [(None, (("x", col("i") * col("i") + col("j")),
                                   ("y", col("i") - lit(7)),
                                   ("z", -col("i"))))],
        "arith_f32": [(col("f") > lit(0.0),
                       (("x", col("f") * (lit(1.0) - col("g"))),
                        ("y", -col("f") + col("g")),
                        ("z", col("f") / col("g"))))],
        "div_int_numerator": [(None, (("x", col("i") / col("j")),
                                      ("y", col("j") / lit(4)),
                                      ("z", col("i") / col("f"))))],
        "promotion": [(col("i") < col("f"), (("x", col("i") + col("f")),
                                             ("y", col("j") * lit(0.5)),
                                             ("c", col("i") == col("g"))))],
        "bool_logic": [(~col("b") | (col("d") >= date_lit("1995-01-01")),
                        (("x", col("b") & (col("j") != lit(0))),
                         ("y", ~(col("f") <= col("g"))),
                         ("z", col("b") == (col("i") > lit(3))),
                         ("t", col("f") & col("i"))))],
        "isin": [(col("j").isin([1, 2, -3]),
                  (("x", col("i").isin([0, -1, 5])),
                   ("y", col("f").isin([0.5, 0.0])),
                   ("z", col("j").isin([1.5, 2.0])),
                   ("e", col("i").isin([]))))],
        "literal_and_passthrough": [(None, (("one", lit(1.0)), ("k", lit(3)),
                                            ("t", lit(True)), ("b", col("b")),
                                            ("d", col("d"))))],
        "three_stages": [(col("f") < lit(5.0), (("a", col("f") * lit(2.0)),
                                                ("i", col("i")))),
                         (col("i") > lit(-20), None),
                         (None, (("s", col("a") + col("i")),
                                 ("t", col("a") >= lit(1.0))))],
        "filters_only": [(col("b"), None), (col("j") >= lit(0), None)],
    }


SEEDED_SCHEMA = {"i": port_dtypes.INT32, "j": port_dtypes.INT32,
                 "f": port_dtypes.FLOAT32, "g": port_dtypes.FLOAT32,
                 "b": port_dtypes.BOOL, "d": port_dtypes.DATE32}

_OP_NAMES = {v: k for k, v in port_fused.OPS.items()}


def emulate(program: "port_fused.Program", table: TorchTable) -> TorchTable:
    """Run ``program`` (no probe) over a CPU ``table`` as the CUDA kernel
    would."""
    assert not program.probe, "use emulate_probe"
    return _emulate(program, table, None)[0]


def emulate_probe(program: "port_fused.Program", table: TorchTable,
                  tk: np.ndarray, tv: np.ndarray, max_probes: int,
                  empty_key: int = -1):
    """Run a ``program`` that ends in PROBE over a CPU ``table`` against
    the table ``(tk, tv)`` -> ``(out_table, found, bidx)`` as numpy."""
    assert program.probe
    return _emulate(program, table, (tk, tv, max_probes, empty_key))


def probe_numpy(tk, tv, keys, max_probes, empty_key=-1):
    """The kernel's linear probe over int32 numpy arrays: walk from the
    home slot, stop at the first equal key (a hit) or empty slot."""
    t = len(tk)
    x = keys.astype(np.int32).view(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x.astype(np.uint64) * np.uint64(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    home = (x & np.uint32(t - 1)).astype(np.int64)
    found = np.zeros(len(keys), bool)
    val = np.zeros(len(keys), np.int32)
    done = np.zeros(len(keys), bool)
    for i in range(min(max_probes, t)):
        idx = (home + i) & (t - 1)
        hit = (tk[idx] == keys) & ~done
        found |= hit
        val[hit] = tv[idx][hit]
        done |= hit | (tk[idx] == empty_key)
    return found, val


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def year_numpy(days) -> np.ndarray:
    """The kernel's YEAR (``year_of`` in fused_interp.cuh) over int32 days:
    1969 before day 0, 2039 from day 25202 on, else the 1461-day cycles
    from 1969-01-01."""
    d = np.asarray(days).astype(np.int64)
    y = 1969 + (4 * (d + 365) + 3) // 1461
    return np.where(d < 0, 1969, np.where(d >= 25202, 2039, y)).astype(
        np.uint32)


def pool_record(pool: bytes, off: int):
    """The pattern record at ``off`` of a program's pool -> ``(mode,
    [part bytes, ...])``."""
    mode, n_parts = pool[off], pool[off + 1]
    parts, at = [], off + 2
    for _ in range(n_parts):
        m = pool[at]
        parts.append(bytes(pool[at + 1:at + 1 + m]))
        at += 1 + m
    return mode, parts


def _match_row(row: bytes, mode: int, parts) -> bool:
    if mode == 1:       # startswith
        return len(parts[0]) <= len(row) and row.startswith(parts[0])
    if mode == 2:       # endswith, on the row trimmed of trailing spaces
        t = row.rstrip(b" ")
        return len(parts[0]) <= len(t) and t.endswith(parts[0])
    start = 0           # contains: each part from the previous hit's end
    for part in parts:
        at = row.find(part, start)
        if at < 0:
            return False
        start = at + len(part)
    return True


def match_numpy(data: np.ndarray, pool: bytes, off: int) -> np.ndarray:
    """The kernel's BYTESMATCH of pool record ``off`` over the rows of a
    uint8[n, W] column -> uint32 0/1 a row."""
    mode, parts = pool_record(pool, off)
    return np.array([_match_row(bytes(r), mode, parts) for r in data],
                    dtype=np.uint32).reshape(len(data))


def _step(op, dst, a, b, regs, ins, n, pool=b"") -> bool:
    """One load or arithmetic/comparison/logic instruction over whole
    columns (the kernel's ``load`` and ``alu``, with YEAR and BYTESMATCH);
    False for any other op."""
    def f32(r):
        return regs[r].view(np.float32)

    def i32(r):
        return regs[r].view(np.int32)

    if op == "LOAD32":
        regs[dst] = _bits(ins[a]).copy()
    elif op == "LOAD8":
        regs[dst] = (ins[a] != 0).astype(np.uint32)
    elif op == "CONST":
        regs[dst] = np.full(n, np.int32(a)).view(np.uint32)
    elif op == "LOADB":
        regs[dst] = ins[a][:, b].astype(np.uint32)
    elif op == "BYTESMATCH":
        regs[dst] = match_numpy(ins[a], pool, b)
    elif op == "YEAR":
        regs[dst] = year_numpy(i32(a))
    elif op in ("ADD_I32", "SUB_I32", "MUL_I32"):
        fn = {"ADD": np.add, "SUB": np.subtract, "MUL": np.multiply}
        regs[dst] = fn[op[:3]](regs[a], regs[b]).astype(np.uint32)
    elif op == "NEG_I32":
        regs[dst] = (np.uint32(0) - regs[a]).astype(np.uint32)
    elif op in ("ADD_F32", "SUB_F32", "MUL_F32", "DIV_F32"):
        fn = {"ADD": np.add, "SUB": np.subtract, "MUL": np.multiply,
              "DIV": np.divide}
        regs[dst] = _bits(fn[op[:3]](f32(a), f32(b)).astype(np.float32))
    elif op == "NEG_F32":
        regs[dst] = regs[a] ^ np.uint32(0x80000000)
    elif op[:2] in ("EQ", "NE", "LT", "LE", "GT", "GE"):
        fn = {"EQ": np.equal, "NE": np.not_equal, "LT": np.less,
              "LE": np.less_equal, "GT": np.greater,
              "GE": np.greater_equal}[op[:2]]
        view = f32 if op.endswith("F32") else i32
        regs[dst] = fn(view(a), view(b)).astype(np.uint32)
    elif op == "AND":
        regs[dst] = ((regs[a] != 0) & (regs[b] != 0)).astype(np.uint32)
    elif op == "OR":
        regs[dst] = ((regs[a] != 0) | (regs[b] != 0)).astype(np.uint32)
    elif op == "NOT":
        regs[dst] = (regs[a] == 0).astype(np.uint32)
    elif op == "I32_TO_F32":
        regs[dst] = _bits(i32(a).astype(np.float32))
    else:
        return False
    return True


def _outputs(program, outs, table):
    """Output columns: the stored registers, or the input tensors a batch
    program's outputs pass through (``out_alias``)."""
    alias = program.out_alias or (None,) * len(program.out_names)
    stored = iter(outs)
    cols = {}
    for name, dtype, src in zip(program.out_names, program.out_dtypes, alias):
        if src is not None:
            cols[name] = table.columns[src]
            continue
        out = next(stored)
        if dtype == torch.bool:
            cols[name] = torch.from_numpy(out.astype(bool))
        else:
            np_dtype = np.float32 if dtype == torch.float32 else np.int32
            cols[name] = torch.from_numpy(out.view(np_dtype).copy())
    return cols


def _emulate(program, table, probe):
    n = table.capacity
    ins = [table.columns[name].numpy() for name in program.in_names]
    valid = table.validity.numpy().copy()
    regs = {}
    outs = [None] * len(program.out_names)

    with np.errstate(all="ignore"):
        for code, dst, a, b in program.code.tolist():
            op = _OP_NAMES[code]
            if _step(op, dst, a, b, regs, ins, n, program.pool):
                continue
            if op == "STORE32":
                outs[dst] = regs[a].copy()
            elif op == "STORE8":
                outs[dst] = regs[a] != 0
            elif op == "FILTER":
                valid &= regs[a] != 0
            elif op == "PROBE":
                tk, tv, max_probes, empty_key = probe
                key = regs[a].view(np.int32)
                hit, bidx = probe_numpy(tk, tv, key, max_probes, empty_key)
                found = hit & valid & (key != empty_key)
            else:
                raise AssertionError(f"emulator: unknown op {op}")
    out = TorchTable(_outputs(program, outs, table),
                     torch.from_numpy(valid), dict(program.out_schema))
    if probe is None:
        return out, None, None
    return out, found, bidx


def param_bits(params, n_members: int) -> list:
    """Each slot's ``[B]`` parameter tensor as the kernel's int32 bits."""
    rows = []
    for p in params:
        a = p.numpy()
        a = a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int32)
        assert a.shape == (n_members,)
        rows.append(a.view(np.uint32))
    return rows


def emulate_batch(program: "port_fused.Program", table: TorchTable, params,
                  n_members: int):
    """Run a batch program over a CPU ``table`` with one ``[B]`` tensor
    per parameter slot as ``fused_batch.cu`` would -> ``(out_table, masks
    bool[B, n])``; the output validity is the input's."""
    assert program.batch
    n = table.capacity
    ins = [table.columns[name].numpy() for name in program.in_names]
    bits = param_bits(params, n_members)
    masks = np.tile(table.validity.numpy(), (n_members, 1))
    regs = {}
    outs = [None] * len(program.out_names)
    code = program.code.tolist()
    pc = 0
    with np.errstate(all="ignore"):
        while pc < len(code):
            op, dst, a, b = _OP_NAMES[code[pc][0]], *code[pc][1:]
            if op == "LOOP":
                end = pc + a
                assert _OP_NAMES[code[end][0]] == "LFILTER"
                before = set(regs)
                for lane in range(n_members):
                    for c2, d2, a2, b2 in code[pc + 1:end]:
                        op2 = _OP_NAMES[c2]
                        if op2 == "PARAM":
                            regs[d2] = np.full(n, bits[a2][lane], np.uint32)
                        else:
                            assert op2 not in ("LOOP", "LFILTER", "STORE32",
                                               "STORE8", "FILTER", "PROBE")
                            assert _step(op2, d2, a2, b2, regs, ins, n,
                                         program.pool), op2
                    masks[lane] &= regs[code[end][2]] != 0
                for r in set(regs) - before:
                    del regs[r]     # a read after the loop raises KeyError
                pc = end + 1
                continue
            if _step(op, dst, a, b, regs, ins, n, program.pool):
                pass
            elif op == "STORE32":
                outs[dst] = regs[a].copy()
            elif op == "STORE8":
                outs[dst] = regs[a] != 0
            else:
                raise AssertionError(f"emulator: {op} in a batch program")
            pc += 1
    out = TorchTable(_outputs(program, [o for o in outs if o is not None],
                              table),
                     table.validity, dict(program.out_schema))
    return out, torch.from_numpy(masks)


# a word the tile model writes where the kernel leaves shared memory
# unwritten: a read of it shows in the results
POISON = np.uint32(0xDEADBEEF)
_WARP_ROWS = 32 * port_fused.LIMITS["kRowsPerThread"]


def emulate_tiles(program: "port_fused.Program", table: TorchTable,
                  params=(), lanes: int = 1, probe=None):
    """Run ``program.plan`` over a CPU ``table`` as the tile kernels would,
    all tiles at once -> ``(out_table, masks bool[lanes, n] or None,
    found, bidx)`` (the probe's as numpy, else None). A batch program's
    output validity is the input's. ``probe``: ``(tk, tv, max_probes,
    empty_key)`` as numpy."""
    lim = port_fused.LIMITS
    plan = program.plan
    rows = lim["kTileRows"]
    shift, low = lim["kKindShift"], (1 << lim["kKindShift"]) - 1
    n = table.capacity
    n_tiles = -(-n // rows)
    size = n_tiles * rows
    ins = [table.columns[name].numpy() for name in program.in_names]

    def padded(a):
        out = np.zeros((size,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    # the load stage of every tile: validity at 0, each column at its
    # offset, zero past n
    stage = np.zeros((n_tiles, plan.stage_bytes), np.uint8)
    stage[:, :rows] = padded(table.validity.numpy().view(np.uint8)).reshape(
        n_tiles, rows)
    for c, width, off in plan.loads:
        raw = np.ascontiguousarray(padded(ins[c])).view(np.uint8)
        stage[:, off:off + rows * width] = raw.reshape(n_tiles, rows * width)
    comp = np.full((n_tiles, plan.comp_bytes // 4), POISON, np.uint32)
    # the pool as the kernel reads it: the packed plan's last 16-byte groups
    groups = -(-plan.pool_bytes // 16)
    words = plan.packed[len(plan.packed) - 4 * groups:] if groups else \
        plan.packed[:0]
    pool = words.numpy().astype("<i4").tobytes()[:plan.pool_bytes]
    # the uniform table, a row a lane
    bits = param_bits(params, lanes)
    uni = np.zeros((lanes, plan.n_uniform), np.uint32)
    for lane in range(lanes):
        for op, dst, a, b in plan.uniform:
            name = _OP_NAMES[op]
            if name == "CONST":
                uni[lane, dst] = np.int32(a).view(np.uint32)
            elif name == "PARAM":
                uni[lane, dst] = bits[a][lane]
            else:
                regs = {0: uni[lane, a:a + 1], 1: uni[lane, b:b + 1]}
                with np.errstate(all="ignore"):
                    assert _step(name, 2, 0, 1, regs, [], 1), name
                uni[lane, dst] = regs[2][0]

    def fetch(e, lane):
        kind, off = e >> shift, e & low
        if kind == lim["kKindComp"]:
            return comp[:, off // 4:off // 4 + rows].copy()
        if kind == lim["kKindRing32"]:
            return stage[:, off:off + 4 * rows].copy().view(np.uint32)
        if kind == lim["kKindRing8"]:
            return (stage[:, off:off + rows] != 0).astype(np.uint32)
        assert kind == lim["kKindUniform"], e
        return np.full((n_tiles, rows), uni[lane, off], np.uint32)

    def vec(op, dst, a, b, lane, skipped=None):
        name = _OP_NAMES[op]
        if name == "LOADB":
            x = padded(ins[a][:, b].astype(np.uint32)).reshape(n_tiles, rows)
        elif name == "BYTESMATCH":
            x = padded(match_numpy(ins[a], pool, b)).reshape(n_tiles, rows)
        else:
            regs = {0: fetch(a, lane), 1: fetch(b, lane)}
            with np.errstate(all="ignore"):
                assert _step(name, 2, 0, 1, regs, [], None), name
            x = regs[2]
        if skipped is not None:
            x = np.where(skipped, POISON, x)
        off = (dst & low) // 4
        comp[:, off:off + rows] = x

    valid = stage[:, :rows] != 0
    live = np.repeat(valid[None], lanes, axis=0)
    stored, found, bidx = {}, None, None
    code = plan.code
    pc = 0
    while pc < len(code):
        op, dst, a, b = code[pc]
        name = _OP_NAMES[op]
        if name in ("STORE32", "STORE8"):
            x = fetch(a, 0).reshape(-1)[:n]
            stored[dst] = x.copy() if name == "STORE32" else x != 0
        elif name == "FILTER":
            valid &= fetch(a, 0) != 0
        elif name == "PROBE":
            tk, tv, max_probes, empty_key = probe
            key = fetch(a, 0).reshape(-1)[:n].view(np.int32)
            hit, bidx = probe_numpy(tk, tv, key, max_probes, empty_key)
            found = hit & valid.reshape(-1)[:n] & (key != empty_key)
        elif name == "LOOP":
            end = pc + a
            assert _OP_NAMES[code[end][0]] == "LFILTER"
            for lane in range(lanes):
                # a warp's 128 rows skip the lane when none is live in it
                warp = live[lane].reshape(n_tiles, rows // _WARP_ROWS,
                                          _WARP_ROWS).any(axis=2)
                skipped = ~np.repeat(warp, _WARP_ROWS, axis=1)
                for op2, dst2, a2, b2 in code[pc + 1:end]:
                    vec(op2, dst2, a2, b2, lane, skipped)
                keep = fetch(code[end][2], lane) != 0
                live[lane] &= keep | skipped
            pc = end
        else:
            vec(op, dst, a, b, 0)
        pc += 1
    outs = [stored[k] for k in sorted(stored)]
    if program.batch:
        out = TorchTable(_outputs(program, outs, table), table.validity,
                         dict(program.out_schema))
        return out, torch.from_numpy(live.reshape(lanes, -1)[:, :n].copy()), \
            None, None
    out = TorchTable(_outputs(program, outs, table),
                     torch.from_numpy(valid.reshape(-1)[:n].copy()),
                     dict(program.out_schema))
    return out, None, found, bidx


def assert_tables_equal(got: TorchTable, want: TorchTable) -> None:
    """Same columns, dtypes, validity and bits (NaNs in the same places)."""
    assert got.column_names == want.column_names
    np.testing.assert_array_equal(got.validity.numpy(), want.validity.numpy())
    for name in want.column_names:
        a, b = got.columns[name], want.columns[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# all 22 TPC-H queries, port against reference
# ---------------------------------------------------------------------------

TPCH_SF = 0.005
TPCH_BATCH_ROWS = 8192


def port_catalog(data: dict):
    """The port's catalog over the reference's generated tables, with the
    primary keys the planner's capacity derivation reads."""
    from repro_torch.core.session import Catalog
    from repro_torch.tpch import schema
    return Catalog.from_numpy(
        data, schema.SCHEMAS, {n: (k,) for n, k in schema.PRIMARY_KEYS.items()})


def run_port_queries(qnums, data, batch_rows: int = TPCH_BATCH_ROWS):
    """Each query's ``build_query`` plan through ``Session(device="cpu")``
    -> ``{q: (plan, result, stats, fused_calls)}``. Every call of the fused
    morsel program is kept (``(table, stages, probe)``), so a test can lower
    and emulate each one the way the card would run it."""
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries
    catalog = port_catalog(data)
    orig = port_fused.fused_morsel_program
    runs = {}
    for q in qnums:
        calls = []

        def keep(table, stages, probe=None, program=None):
            calls.append((table, stages, probe))
            return orig(table, stages, probe=probe, program=program)

        plan = queries.build_query(q, catalog)
        session = Session(catalog, batch_rows=batch_rows, device="cpu")
        port_fused.fused_morsel_program = keep
        try:
            out = session.execute(plan)
        finally:
            port_fused.fused_morsel_program = orig
        runs[q] = (plan, out, session.executor_stats(), calls)
    return runs


def emulate_fused_call(table: TorchTable, stages, probe) -> None:
    """Lower one fused call as the card's ``FusedMorsel`` lowers it
    (``fused.lower_split``: one program, or consecutive ones where the run
    passes the kernel's limits), run each program through the emulator on
    the previous one's output, and assert the result equals the plain
    version (``apply_stages`` and ``apply_probe``) bit for bit."""
    runs = port_fused.lower_split(
        table, stages,
        probe_keys=None if probe is None else probe["probe_keys"],
        pack=None if probe is None else probe["pack"])
    cur = table
    for _, program in runs[:-1]:
        assert program.code.shape[0] <= port_fused.LIMITS["kMaxInstr"]
        cur = emulate(program, cur)
    program = runs[-1][1]
    assert program.code.shape[0] <= port_fused.LIMITS["kMaxInstr"]
    want = port_fused.apply_stages(table, stages)
    if probe is None:
        assert_tables_equal(emulate(program, cur), want)
        return
    got, found, bidx = emulate_probe(
        program, cur, probe["tk"].numpy(), probe["tv"].numpy(),
        probe["max_probes"], probe["empty_key"])
    assert_tables_equal(got, want)
    wf, wb = port_fused.apply_probe(want, probe)
    np.testing.assert_array_equal(found, wf.numpy())
    np.testing.assert_array_equal(bidx, wb.numpy())


def run_ref_queries(qnums, sf: float = TPCH_SF,
                    batch_rows: int = TPCH_BATCH_ROWS):
    """The reference's optimized plan of each query under its ``pallas``
    backend (kernels in interpret mode) -> ``{q: (plan, result, stats)}``."""
    from repro.core.session import Session as RefSession
    from repro.tpch import dbgen as ref_dbgen
    from repro.tpch import queries as ref_queries
    catalog = ref_dbgen.load_catalog(sf=sf)
    runs = {}
    for q in qnums:
        plan = ref_queries.build_query(q, catalog)
        session = RefSession(catalog, batch_rows=batch_rows,
                             kernel_backend="pallas")
        runs[q] = (plan, session.execute(plan), session.executor_stats())
    return runs


def assert_same_result(got: dict, want: dict, q: int) -> None:
    """Same columns, dtypes and row shapes, and the rows of
    ``tpch_util.assert_results_match`` (exact for keys and counts, rtol
    2e-3 for floats)."""
    from tpch_util import assert_results_match
    # the reference's pytree flattening sorts columns by name
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        assert got[c].shape == want[c].shape, c
    assert_results_match(got, want, q)


# ---------------------------------------------------------------------------
# distributed runs (W workers on one device), port against reference
# ---------------------------------------------------------------------------

DIST_SF = 0.002
# the sample of the reference's distributed oracle slice
HOST_SAMPLE = (1, 3, 5, 6, 13, 22)
_EXCHANGE_COUNTERS = ("rounds", "rows_moved", "bytes_moved",
                      "host_staged_bytes")


def run_port_dist(qnums, data, num_workers: int, proto: str = "ici"):
    """Each query's ``build_query(q, catalog, num_workers=W)`` plan through
    ``Session(device="cpu", num_workers=W, exchange=...)`` ->
    ``{q: (plan, result, stats)}``."""
    from repro_torch import HostExchange, ICIExchange
    from repro_torch.core.session import Session
    from repro_torch.tpch import queries
    catalog = port_catalog(data)
    runs = {}
    for q in qnums:
        plan = queries.build_query(q, catalog, num_workers=num_workers)
        ex = ICIExchange() if proto == "ici" else HostExchange()
        session = Session(catalog, batch_rows=TPCH_BATCH_ROWS, device="cpu",
                          num_workers=num_workers, exchange=ex)
        runs[q] = (plan, session.execute(plan), session.executor_stats())
    return runs


def run_ref_dist(qnums, num_workers: int, proto: str = "ici",
                 pallas=(), sf: float = DIST_SF):
    """The reference's distributed plan of each query at ``num_workers``
    under ``proto`` -> ``{q: (plan, result, stats)}``; the queries in
    ``pallas`` run under its ``pallas`` backend (kernels in interpret
    mode), the others under ``jnp`` (the same results, faster)."""
    from repro.core import HostExchange, ICIExchange
    from repro.core.session import Session as RefSession
    from repro.tpch import dbgen as ref_dbgen
    from repro.tpch import queries as ref_queries
    catalog = ref_dbgen.load_catalog(sf=sf)
    runs = {}
    for q in qnums:
        plan = ref_queries.build_query(q, catalog, num_workers=num_workers)
        ex = ICIExchange() if proto == "ici" else HostExchange()
        session = RefSession(catalog, batch_rows=TPCH_BATCH_ROWS,
                             num_workers=num_workers, exchange=ex,
                             kernel_backend="pallas" if q in pallas else "jnp")
        runs[q] = (plan, session.execute(plan), session.executor_stats())
    return runs


def port_mesh_session(catalog, num_workers: int, devices: int = 1,
                      **kw):
    """The port's mesh session on the CPU: ``Session(device="cpu",
    num_workers=W, mesh=EngineMesh([cpu] * devices))`` at
    ``TPCH_BATCH_ROWS``, with ``kw`` (``device_budget=``, ``feedback=``,
    ``exchange=``, ...)."""
    import torch

    from repro_torch.core.session import Session
    from repro_torch.launch.mesh import EngineMesh
    kw.setdefault("batch_rows", TPCH_BATCH_ROWS)
    return Session(catalog, device="cpu", num_workers=num_workers,
                   mesh=EngineMesh([torch.device("cpu")] * devices), **kw)


def ref_mesh_session(catalog, num_workers: int, backend: str = "jnp", **kw):
    """The reference's session on a one-device mesh (``make_engine_mesh(1)``,
    ``ICIExchange(mesh=...)``) under ``backend`` at ``TPCH_BATCH_ROWS``,
    with ``kw``."""
    from repro.core import ICIExchange
    from repro.core.session import Session as RefSession
    from repro.launch.mesh import make_engine_mesh
    mesh = make_engine_mesh(1)
    kw.setdefault("batch_rows", TPCH_BATCH_ROWS)
    return RefSession(catalog, num_workers=num_workers, mesh=mesh,
                      exchange=ICIExchange(mesh=mesh), kernel_backend=backend,
                      **kw)


def run_port_mesh(qnums, data, num_workers: int, proto: str = "ici", **kw):
    """Each query's ``build_query(q, catalog, num_workers=W)`` plan through
    ``port_mesh_session`` (the staged on-mesh exchange; ``kw`` to the
    session) -> ``{q: (plan, result, stats)}``."""
    from repro_torch import HostExchange
    from repro_torch.tpch import queries
    catalog = port_catalog(data)
    runs = {}
    for q in qnums:
        plan = queries.build_query(q, catalog, num_workers=num_workers)
        session = port_mesh_session(
            catalog, num_workers,
            exchange=None if proto == "ici" else HostExchange(), **kw)
        runs[q] = (plan, session.execute(plan), session.executor_stats())
    return runs


def run_ref_mesh(qnums, num_workers: int, sf: float = DIST_SF, **kw):
    """The reference's distributed plan of each query at ``num_workers`` on
    a one-device mesh (``ref_mesh_session``: the staged layout, the
    worker-axis transpose, receive-side compaction; ``kw`` to the session)
    under its ``jnp`` backend -> ``{q: (plan, result, stats)}``."""
    from repro.tpch import dbgen as ref_dbgen
    from repro.tpch import queries as ref_queries
    catalog = ref_dbgen.load_catalog(sf=sf)
    runs = {}
    for q in qnums:
        plan = ref_queries.build_query(q, catalog, num_workers=num_workers)
        session = ref_mesh_session(catalog, num_workers, **kw)
        runs[q] = (plan, session.execute(plan), session.executor_stats())
    return runs


def exchange_counters(stats: dict) -> dict:
    """Per-fragment exchange counters of ``executor_stats()`` (label ->
    rounds, rows and bytes moved, bytes staged through the host)."""
    return {label: {k: v[k] for k in _EXCHANGE_COUNTERS}
            for label, v in stats["exchanges"].items()}


# ---------------------------------------------------------------------------
# the exchange's metadata pass, as the kernel walks it
# ---------------------------------------------------------------------------

def _fmix_masked(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x & np.uint32(0x7FFFFFFE)


def emulate_partition(key_cols_per_source, validity_per_source, w,
                      pids_addr=0):
    """``partition_histogram_run`` on CPU tensors (1-D int32 or 2-D uint8
    key columns, bool validity) -> (pids int32[sum n], counts int32[W, W])
    as numpy, the flat pids at ``pids_addr``. Asserts what the kernel
    relies on: each array it loads or stores whole (an int4, the validity's
    4-byte word) is aligned at every full chunk, and the chunks cover each
    row once."""
    pids, counts, at = [], np.zeros((w, w), np.int64), 0
    for src, (cols, valid) in enumerate(zip(key_cols_per_source,
                                            validity_per_source)):
        n = valid.shape[0]
        ints = [c for c in cols if c.dim() == 1]
        base = (ints[0].data_ptr() if ints else pids_addr + 4 * at)
        head = (base & 15) >> 2 if n else 0
        chunks = (n + head + 3) // 4
        r0 = np.arange(chunks, dtype=np.int64) * 4 - head
        full = (r0 >= 0) & (r0 + 4 <= n)
        rows = (r0[:, None] + np.arange(4)[None, :]).ravel()
        rows = rows[(rows >= 0) & (rows < n)]
        assert np.array_equal(rows, np.arange(n)), "chunks miss or repeat rows"
        for c in ints:
            if (c.data_ptr() - 4 * head) % 16 == 0:
                assert all((c.data_ptr() + 4 * r) % 16 == 0 for r in r0[full])
        if (valid.data_ptr() - head) % 4 == 0:
            assert all((valid.data_ptr() + r) % 4 == 0 for r in r0[full])
        if (pids_addr + 4 * (at - head)) % 16 == 0:
            assert all((pids_addr + 4 * (at + r)) % 16 == 0 for r in r0[full])
        live = valid.numpy().astype(bool)
        chunk_live = np.zeros(chunks, bool)
        np.logical_or.at(chunk_live, (np.arange(n) + head) // 4, live)
        read = chunk_live[(np.arange(n) + head) // 4]
        h = np.zeros(n, np.uint32)
        for c in cols:
            a = c.numpy()
            if a.ndim == 1:
                u = a.astype(np.int32).view(np.uint32)
            else:
                u = np.zeros(n, np.uint32)
                for j in range(a.shape[1]):
                    u = u * np.uint32(31) + a[:, j].astype(np.uint32)
            u = np.where(read, u, np.uint32(0))
            h = h ^ (_fmix_masked(u) + np.uint32(0x9E3779B9)
                     + (h << np.uint32(6)) + (h >> np.uint32(2)))
        pid = np.where(live, (h & np.uint32(0x7FFFFFFE)) % np.uint32(w),
                       w).astype(np.int32)
        counts[src] = np.bincount(pid[live], minlength=w)[:w]
        pids.append(pid)
        at += n
    return np.concatenate(pids) if pids else np.zeros(0, np.int32), \
        counts.astype(np.int32)


# ---------------------------------------------------------------------------
# the segmented reductions, as the kernel walks them
# ---------------------------------------------------------------------------

_SEG_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
               / "kernels" / "csrc" / "segmented_agg.cu")


def _seg_const(name, **earlier):
    """A ``constexpr int`` of ``csrc/segmented_agg.cu``, in C's integer
    arithmetic over the constants ``earlier`` names."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", _SEG_SOURCE.read_text())
    return eval(m.group(1).replace("/", "//"), earlier)  # noqa: S307


SEG_THREADS = _seg_const("kThreads")
SEG_CHUNK = _seg_const("kChunkRows")
SEG_WARPS = _seg_const("kWarps", kThreads=SEG_THREADS)
SEG_STEPS_AHEAD = _seg_const("kStepsAhead")
SEG_RANGE_STEPS = _seg_const("kRangeSteps")
SEG_SHARED_GROUPS = _seg_const("kSharedGroups")
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


class SumOp:
    """``SumOp<T>``: float32 sums (the xor butterfly for a warp), or int32
    sums in uint32, wrapping."""

    def __init__(self, dtype):
        self.acc = np.uint32 if np.dtype(dtype) == np.int32 else np.float32
        self.identity = self.acc(0)

    def of(self, vals):
        return vals.view(np.uint32) if self.acc is np.uint32 else vals

    def combine(self, a, b):
        if self.acc is np.uint32:
            return self.acc((int(a) + int(b)) & 0xFFFFFFFF)
        return self.acc(a + b)

    def warp_all(self, xs):
        if self.acc is np.uint32:
            return self.acc(sum(int(x) for x in xs) & 0xFFFFFFFF)
        xs = list(xs)
        for off in (16, 8, 4, 2, 1):
            xs = [self.acc(xs[i] + xs[i ^ off]) for i in range(32)]
        return xs[0]

    def out_init(self, g):
        return np.zeros(g, self.acc)

    def to_out(self, out, g, v):
        out[g] = self.combine(out[g], v)

    def result(self, out):
        return out.view(np.int32) if self.acc is np.uint32 else out


def f32_keys(vals, kind):
    """The kernel's int32 key of each float32: signed order = the IEEE
    total order; a NaN is the key that wins (INT_MIN for min, INT_MAX for
    max)."""
    b = vals.view(np.int32).astype(np.int64)
    k = b ^ ((b >> 31) & 0x7FFFFFFF)
    return np.where(np.isnan(vals), _I32_MIN if kind == "min" else _I32_MAX,
                    k).astype(np.int64)


def key_bits(k):
    """A key's float bits as an int32 (the map is its own inverse)."""
    k = int(k)
    return k ^ ((k >> 31) & 0x7FFFFFFF)


class MinMaxOp:
    """``MinMaxOp<T, kMin>``: int32 keys (float32 values by ``f32_keys``),
    min or max; the output updated by the sign-split integer atomics on the
    float bits (int32 by plain min/max)."""

    def __init__(self, dtype, kind):
        self.float = np.dtype(dtype) == np.float32
        self.min = kind == "min"
        self.kind = kind
        pick = min if self.min else max
        self.combine = lambda a, b: pick(a, b)
        if self.float:
            inf = np.array([np.inf if self.min else -np.inf], np.float32)
            self.identity = int(f32_keys(inf, kind)[0])
            self.out_identity = int(inf.view(np.int32)[0])
        else:
            self.identity = _I32_MAX if self.min else _I32_MIN
            self.out_identity = self.identity

    def of(self, vals):
        if self.float:
            return f32_keys(vals, self.kind)
        return vals.astype(np.int64)

    def warp_all(self, xs):
        return min(xs) if self.min else max(xs)

    def out_init(self, g):
        return np.full(g, self.out_identity, np.int64)

    def to_out(self, out, g, v):
        if not self.float:
            out[g] = self.combine(int(out[g]), int(v))
            return
        bits, cur = key_bits(v), int(out[g])
        if bits >= 0:
            # atomicMin / atomicMax on int
            out[g] = min(cur, bits) if self.min else max(cur, bits)
        else:
            # atomicMax / atomicMin on unsigned
            u, ucur = bits & 0xFFFFFFFF, cur & 0xFFFFFFFF
            w = max(ucur, u) if self.min else min(ucur, u)
            out[g] = w - (1 << 32) if w >= 1 << 31 else w

    def result(self, out):
        o = out.astype(np.int32)
        return o.view(np.float32) if self.float else o


class SegTrace:
    """What a model run did: the updates ("fold" for a run's, "flush" for a
    shared partial's; the range, or the CTA for a flush; the group; the
    value), the chunks whose values were loaded, and the chunks with a live
    id."""

    def __init__(self):
        self.adds = []
        self.value_chunks = []
        self.live_chunks = []


def _shfl_up(x, d):
    return [x[i - d] if i >= d else x[i] for i in range(32)]


def seg_fold_chunk(g, v, op, add):
    """``fold_chunk``: (have, [fk, fs, lk, ls, one])."""
    have, fk, lk, fs, ls, one = (False, -1, -1, op.identity, op.identity,
                                 True)
    for k in range(SEG_CHUNK):
        if g[k] < 0:
            continue
        if not have:
            have, fk, lk, ls = True, g[k], g[k], v[k]
        elif g[k] == lk:
            ls = op.combine(ls, v[k])
        else:
            if one:
                fs, one = ls, False
            else:
                add(lk, ls)
            lk, ls = g[k], v[k]
    if one:
        fs = ls
    return have, [fk, fs, lk, ls, one]


def seg_fold_warp(have, lanes, op, add):
    """``fold_warp`` over 32 lanes' runs ([fk, fs, lk, ls, one] each):
    None when no lane has a live row, else the joined [fk, fs, lk, ls,
    one]."""
    live = [i for i in range(32) if have[i]]
    if not live:
        return None
    fk, fs, lk, ls, one = (list(x) for x in zip(*lanes))
    if len(live) < 32:
        src = {i: (lk[max(j for j in live if j < i)] if any(j < i for j in live)
                   else fk[min(j for j in live if j > i)])
               for i in range(32) if not have[i]}
        for i, k in src.items():
            fk[i] = lk[i] = k
            fs[i] = ls[i] = op.identity
            one[i] = True
    k0 = fk[0]
    if all(one[i] and fk[i] == k0 for i in range(32)):
        s = op.warp_all(ls)
        return [k0, s, k0, s, True]
    prev_lk = _shfl_up(lk, 1)
    next_fk = fk[1:] + [fk[31]]
    joins = [i > 0 and prev_lk[i] == fk[i] for i in range(32)]
    heads = [not (joins[i] and one[i]) for i in range(32)]
    start = [max(j for j in range(i + 1) if heads[j]) for i in range(32)]
    s = list(ls)
    for off in (1, 2, 4, 8, 16):
        o = _shfl_up(s, off)
        s = [op.combine(s[i], o[i]) if i - off >= start[i] else s[i]
             for i in range(32)]
    s_prev, start_prev, one0 = _shfl_up(s, 1), _shfl_up(start, 1), one[0]
    ends = [i == 31 or next_fk[i] != lk[i] for i in range(32)]
    holders = []
    for i in range(32):
        if not one[i]:
            e = op.combine(fs[i], s_prev[i]) if joins[i] else fs[i]
            if i == 0 or (joins[i] and start_prev[i] == 0 and one0):
                holders.append((i, e))
            else:
                add(fk[i], e)
            if i != 31 and ends[i]:
                add(lk[i], s[i])
        elif ends[i]:
            if start[i] == 0 and one0:
                holders.append((i, s[i]))
            elif i != 31:
                add(lk[i], s[i])
    assert len(holders) == 1, holders
    i, first = holders[0]
    assert i != 31 or not one[31]
    return [fk[i], first, lk[31], s[31], False]


def seg_join_runs(state, nxt, op, add):
    """``join_runs``: ``state`` = [open, [fk, fs, lk, ls, one]] followed by
    the runs ``nxt``."""
    if not state[0]:
        state[:] = [True, list(nxt)]
        return
    a = state[1]
    afk, afs, alk, als, aone = a
    nfk, nfs, nlk, nls, none = nxt
    if alk == nfk:
        joined = op.combine(als, nfs)
        if aone and none:
            a[1] = a[3] = joined
        elif aone:
            a[:] = [afk, joined, nlk, nls, False]
        elif none:
            a[3] = joined
        else:
            add(alk, joined)
            a[2], a[3] = nlk, nls
    else:
        if not aone:
            add(alk, als)
        if not none:
            add(nfk, nfs)
        a[2], a[3], a[4] = nlk, nls, False


def _seg_range(gids, vals, num_groups, n, a, vec, s_begin, s_end, op, trace,
               k, add):
    """One warp's range of steps; ``add(key, v)`` takes its updates."""
    def fold_add(key, v):
        assert 0 <= key < num_groups
        trace.adds.append(("fold", k, key, v))
        add(key, v)

    state = [False, [-1, op.identity, -1, op.identity, True]]
    for st in range(s_begin, s_end, SEG_STEPS_AHEAD):
        loaded = []
        for u in range(SEG_STEPS_AHEAD):
            step = []
            for lane in range(32):
                r0 = ((st + u) * 32 + lane) * SEG_CHUNK - a
                g = [int(gids[r]) if st + u < s_end and 0 <= r < n else -1
                     for r in range(r0, r0 + SEG_CHUNK)]
                step.append((r0, [x if 0 <= x < num_groups else -1
                                  for x in g]))
            loaded.append(step)
        if all(x < 0 for step in loaded for _, g in step for x in g):
            continue        # no live id in the warp's steps
        values = []
        for u, step in enumerate(loaded):
            vs = []
            for lane, (r0, g) in enumerate(step):
                v = [op.identity] * SEG_CHUNK
                if any(x >= 0 for x in g):
                    chunk = (st + u) * 32 + lane
                    trace.live_chunks.append(chunk)
                    trace.value_chunks.append(chunk)
                    full = vec and r0 >= 0 and r0 + SEG_CHUNK <= n
                    v = [vals[r0 + j] if (full or g[j] >= 0) else op.identity
                         for j in range(SEG_CHUNK)]
                vs.append(v)
            values.append(vs)
        for u in range(SEG_STEPS_AHEAD):
            have, lanes = [], []
            for lane in range(32):
                h, r = seg_fold_chunk(loaded[u][lane][1], values[u][lane], op,
                                      fold_add)
                have.append(h)
                lanes.append(r)
            w = seg_fold_warp(have, lanes, op, fold_add)
            if w is not None:
                seg_join_runs(state, w, op, fold_add)
    if state[0]:
        fk, fs, lk, ls, one = state[1]
        fold_add(fk, fs)
        if not one:
            fold_add(lk, ls)


def emulate_segmented(gids, vals, num_groups, grid, op, id_offset=0,
                      val_offset=0, rng=None):
    """One launch of ``reduce_rows<Op, ...>`` (``segmented_sum_kernel`` or
    ``segmented_minmax_kernel``) on ``grid`` CTAs (the launch takes
    min(resident CTAs, tiles)), with the ids' base ``id_offset`` and the
    values' ``val_offset`` rows past a 16-byte boundary, the combining
    operation ``op`` (``SumOp`` or ``MinMaxOp``): (result, SegTrace). The
    output starts from ``op.out_init`` (the wrapper's zeros, or the fill
    kernel's identity); its updates are applied in the order the model
    makes them, or, with ``rng``, in a random order, as atomics from
    concurrent warps and CTAs land."""
    n = len(gids)
    out = op.out_init(num_groups)
    trace = SegTrace()
    if n == 0 or num_groups == 0:
        return op.result(out), trace
    vals = op.of(vals)
    a = id_offset % SEG_CHUNK
    vec = val_offset % SEG_CHUNK == a
    chunks = -(-(n + a) // SEG_CHUNK)
    steps = -(-chunks // 32)
    grid = min(grid, -(-chunks // SEG_THREADS))
    warps = grid * SEG_WARPS
    rng_steps = -(-steps // warps)
    rng_steps = min(-(-rng_steps // SEG_STEPS_AHEAD) * SEG_STEPS_AHEAD,
                    SEG_RANGE_STEPS)
    shared = num_groups <= SEG_SHARED_GROUPS
    updates = []
    for b in range(grid):
        part = [op.identity] * num_groups if shared else None

        def add(key, v, part=part):
            if shared:
                part[key] = op.combine(part[key], v)
            else:
                updates.append((key, v))

        for warp in range(SEG_WARPS):
            k = b * SEG_WARPS + warp
            while k * rng_steps < steps:
                _seg_range(gids, vals, num_groups, n, a, vec, k * rng_steps,
                           min((k + 1) * rng_steps, steps), op, trace, k, add)
                k += warps
        if shared:
            for g in range(num_groups):
                if part[g] != op.identity:
                    trace.adds.append(("flush", b, g, part[g]))
                    updates.append((g, part[g]))
    order = (rng.permutation(len(updates)) if rng is not None
             else range(len(updates)))
    for i in order:
        op.to_out(out, *updates[i])
    return op.result(out), trace
