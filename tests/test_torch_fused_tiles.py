"""The fused kernels' tile design on the CPU: the slot assignment
(``fused.assign_slots``) and the tile plan it lays out, run through the
emulators of ``torch_diff`` and a numpy model of the tile schedule
(``torch_diff.emulate_tiles``: 1024-row tiles, four rows a thread, the load
stage and computed slots at the plan's byte offsets, zero fill past n, a
lane skipped by a warp's 128 rows), against the plain versions
(``apply_stages``, ``apply_batched_stages``, ``apply_probe``) and the
reference's Pallas kernels in interpret mode.

Everything is exact: the kernels' float instructions round to nearest like
the plain versions, so outputs, validity, masks, found and bidx must be
bit-identical.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dtypes as rdt
from repro.core import fused as ref_fused
from repro.core.table import DeviceTable
from repro.core.expr import col as ref_col
from repro.core.expr import date_lit as ref_date_lit
from repro.core.expr import lit as ref_lit
from repro.tpch import dbgen as ref_dbgen

from torch_diff import (SEEDED_SCHEMA, assert_tables_equal, emulate,
                        emulate_batch, emulate_tiles, port_catalog,
                        run_port_queries, seeded_columns, stage_cases, to_port)

from repro_torch.core import batch
from repro_torch.core import dtypes as port_dtypes
from repro_torch.core import fused
from repro_torch.core.builder import QueryBuilder
from repro_torch.core.expr import col, date_lit, lit
from repro_torch.core.table import TorchTable
from repro_torch.kernels import hash_probe as hp
from repro_torch.tpch import queries

ROOT = Path(__file__).resolve().parents[1]
LIM = fused.LIMITS
BASE = LIM["kUniformBase"]
SF = 0.005
_CASES = stage_cases(col, lit, date_lit)
# n: none, fewer than a thread's four, a whole tile, ragged tails
_SIZES = (0, 1, 3, 1024, 5000, 999_999)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def dataset():
    data = ref_dbgen.generate(sf=SF)
    return data, port_catalog(data)


def _seeded(n: int, seed: int = 11) -> TorchTable:
    """``seeded_columns`` at n rows, every seventh row dead."""
    cols = {k: torch.from_numpy(np.ascontiguousarray(v[:n])).to(
        SEEDED_SCHEMA[k].torch_dtype())
        for k, v in seeded_columns(max(n, 4), seed).items()}
    return TorchTable(cols, torch.from_numpy(np.arange(n) % 7 != 3),
                      dict(SEEDED_SCHEMA))


def _check_slots(raw: fused.Program, got: fused.Program) -> None:
    """The classes and numbering of ``assign_slots``: a register is
    uniform iff its one definition is a CONST, a PARAM or an ALU
    instruction on uniform operands; uniform slots from kUniformBase,
    vector slots below n_vec."""
    assert raw.plan is None and got.plan is not None
    assert got.n_vec + got.n_uniform <= raw.n_regs
    assert got.n_vec <= LIM["kMaxRegs"] <= BASE
    uniform = set()
    ops = {v: k for k, v in fused.OPS.items()}
    for (op, dst, a, b), (op2, dst2, *_) in zip(raw.code.tolist(),
                                                got.code.tolist()):
        assert op == op2
        name = ops[op]
        if op not in fused._DEFINES:
            continue
        unary = name in ("NEG_I32", "NEG_F32", "NOT", "I32_TO_F32")
        is_uni = name in ("CONST", "PARAM") or (
            op in fused._ALU and a in uniform and (unary or b in uniform))
        if is_uni:
            uniform.add(dst)
            assert BASE <= dst2 < BASE + got.n_uniform, (name, dst2)
        else:
            assert 0 <= dst2 < got.n_vec, (name, dst2)
    plan = got.plan
    assert plan.smem_bytes(LIM["kMaxLanes"] if got.batch else 1) \
        <= LIM["kMaxSmem"]
    assert len(plan.uniform) + len(plan.code) <= LIM["kMaxInstr"]


def _lower(table, stages, **kw):
    raw = fused.lower_registers(table, stages, **kw)
    got = fused.assign_slots(raw)
    _check_slots(raw, got)
    return got


# ---------------------------------------------------------------------------
# the slot assignment, through the register emulators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(_CASES))
def test_slot_assignment_emulates_plain(case):
    t = _seeded(3000)
    program = _lower(t, _CASES[case])
    assert fused.lower_stages(t, _CASES[case]).code.tolist() \
        == program.code.tolist()
    want = fused.apply_stages(t, _CASES[case])
    assert_tables_equal(emulate(program, t), want)
    assert_tables_equal(emulate_tiles(program, t)[0], want)


def _parameterized(case: str, lanes: int):
    """``case``'s stages with their filter literals as parameters, distinct
    in every lane."""
    dtypes, values, stages = [], [], []
    for filter_expr, projections in _CASES[case]:
        if filter_expr is not None:
            filter_expr = batch._parameterize(filter_expr, dtypes, values)
        stages.append((filter_expr, projections))

    def value(v, d, b):
        if d.name == "bool":
            return bool(v) != bool(b % 2)
        if d.name in ("float32", "float64"):
            return float(v) + 0.5 * b
        return int(v) + (30 if d.name == "date32" else 1) * b

    params = tuple(torch.tensor([value(v, d, b) for b in range(lanes)],
                                dtype=d.torch_dtype())
                   for d, v in zip(dtypes, values))
    return stages, params


@pytest.mark.parametrize("case", sorted(_CASES))
def test_batch_slot_assignment_emulates_plain(case):
    lanes = 5
    t = _seeded(3000, seed=5)
    stages, params = _parameterized(case, lanes)
    program = _lower(t, stages, batch=True)
    want, want_masks = fused.apply_batched_stages(t, stages, params, lanes)
    got, masks = emulate_batch(program, t, params, lanes)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())
    got, masks, _, _ = emulate_tiles(program, t, params, lanes)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())


def test_registers_before_a_loop_keep_their_slots():
    """The lowering loads a filter's columns before its LOOP; read in the
    body, they keep slots of their own, outside the body's, whose PARAMs
    and the uniform sum of two of them (3 + 4, both lifted) take uniform
    slots. The batch emulator drops the body's slots after the loop, so a
    clash would raise there; after it, the projection's own 3 + 4 is a
    uniform slot that STORE32 writes."""
    t = _seeded(500)
    dtypes, values = [], []
    pred = batch._parameterize(
        (col("i") * lit(2) > lit(3) + lit(4)) & (col("j") < lit(2)),
        dtypes, values)
    stages = [(pred, (("x", col("i") * lit(2)), ("y", lit(3) + lit(4))))]
    params = tuple(torch.tensor([int(v) + 3 * b - 4 for b in range(3)],
                                dtype=torch.int32) for v in values)
    program = _lower(t, stages, batch=True)
    code = program.code.tolist()
    loop = next(k for k, r in enumerate(code) if r[0] == fused.OPS["LOOP"])
    before = {r[1] for r in code[:loop] if r[0] in fused._DEFINES}
    body = {r[1] for r in code[loop + 1:loop + code[loop][2]]
            if r[0] in fused._DEFINES}
    assert before & {x for r in code[loop + 1:] for x in r[2:]}
    assert not before & body
    assert any(s >= BASE for s in body) and any(s < BASE for s in body)
    assert code[-1][0] == fused.OPS["STORE32"] and code[-1][2] >= BASE
    want = fused.apply_batched_stages(t, stages, params, 3)
    for got in (emulate_batch(program, t, params, 3),
                emulate_tiles(program, t, params, 3)[:2]):
        assert_tables_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("case", ["isin", "bool_logic", "three_stages"])
def test_dead_computed_slots_are_reused(case):
    """A computed slot is taken again once its register is dead: fewer
    vector slots than vector registers, the loads' slots never shared, and
    the results unchanged."""
    t = _seeded(2000)
    raw = fused.lower_registers(t, _CASES[case])
    program = _lower(t, _CASES[case])
    loads = {fused.OPS["LOAD32"], fused.OPS["LOAD8"]}
    vector = [d for (op, d, _, _), (_, d2, _, _) in zip(
        raw.code.tolist(), program.code.tolist())
        if op in fused._DEFINES and d2 < BASE]
    assert program.n_vec < len(vector)
    load_slots = [r[1] for r in program.code.tolist() if r[0] in loads]
    others = [r[1] for r in program.code.tolist()
              if r[0] in fused._DEFINES and r[0] not in loads
              and r[1] < BASE]
    assert len(set(load_slots)) == len(load_slots)
    assert not set(load_slots) & set(others)
    want = fused.apply_stages(t, _CASES[case])
    assert_tables_equal(emulate(program, t), want)
    assert_tables_equal(emulate_tiles(program, t)[0], want)


def _query_stages(q: int):
    """The fused stages of TPC-H query ``q`` as the port's ``FusedMorsel``
    receives them, on its first morsel: Q1's and Q6's scan (as
    ``chip_smoke.py`` takes them) and Q22's ``PrefixCode`` stages (the
    fused calls of a CPU run)."""
    data, catalog = dataset()
    if q == 22:
        calls = run_port_queries([22], data)[22][3]
        table, stages, probe = next(c for c in calls if c[2] is None)
        return table, stages
    morsel = TorchTable.from_numpy(data["lineitem"],
                                   catalog.get("lineitem").schema,
                                   device="cpu")
    return _chip_smoke().fused_case(queries, catalog, morsel, q)


@pytest.mark.parametrize("q", [1, 6, 22])
def test_slot_assignment_on_query_stages(q):
    table, stages = _query_stages(q)
    program = _lower(table, stages)
    want = fused.apply_stages(table, stages)
    assert_tables_equal(emulate(program, table), want)
    assert_tables_equal(emulate_tiles(program, table)[0], want)
    if q == 22:
        assert (program.code[:, 0] == fused.OPS["LOADB"]).sum() == 2
    # the scans' plans keep two load stages
    assert program.plan.stages == 2


def _serving(shape: str, lanes: int):
    """(table, pre-stages, params) of the serving shape's batch program on
    a lineitem or orders morsel of 5000 rows, ``lanes`` distinct literals;
    lane ``lanes - 1`` of a point lookup matches no row at all."""
    data, catalog = dataset()
    cs = _chip_smoke()
    keys = data["orders"]["o_orderkey"]
    shapes = [batch.extract_shape(cs.small_query(
        QueryBuilder, col, catalog, keys, shape, j).optimized())
        for j in range(lanes)]
    prog = shapes[0].program
    src = data[prog.table]
    schema = catalog.get(prog.table).schema
    t = TorchTable.from_numpy({c: src[c][:5000] for c in prog.columns},
                              {c: schema[c] for c in prog.columns},
                              device="cpu")
    params = batch._params(prog, shapes, lanes, t.device)
    if shape == "point":
        params = (torch.cat([params[0][:-1],
                             torch.tensor([-7], dtype=params[0].dtype)]),)
    return t, prog.pre_stages, params


@pytest.mark.parametrize("shape", ["point", "global", "group"])
def test_slot_assignment_on_serving_programs(shape):
    t, stages, params = _serving(shape, 32)
    program = _lower(t, stages, batch=True)
    assert program.plan.stages == 2
    want, want_masks = fused.apply_batched_stages(t, stages, params, 32)
    for got, masks in (emulate_batch(program, t, params, 32),
                       emulate_tiles(program, t, params, 32)[:2]):
        assert_tables_equal(got, want)
        np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())


# ---------------------------------------------------------------------------
# the tile schedule at every size
# ---------------------------------------------------------------------------

def _probe_case(t: TorchTable):
    """A probe of column i into a table of some of its values (keys 0 and
    -1 among them): stages, probe dict (torch) and numpy table."""
    keys = np.arange(-40, 40, 3).astype(np.int32)
    keys[0] = -1
    tk, tv = hp.build_table_plain(torch.from_numpy(keys),
                                  torch.arange(len(keys), dtype=torch.int32),
                                  128, -1)
    probe = dict(tk=tk, tv=tv, probe_keys=("i",), pack=None, empty_key=-1,
                 max_probes=hp.probe_bound(tk))
    stages = [(col("f") < lit(5.0), (("i", col("i")), ("a", col("f") * lit(2.0))))]
    return stages, probe


@pytest.mark.parametrize("n", _SIZES)
def test_tile_model_fused_program(n):
    t = _seeded(n)
    for case in ("bool_logic", "three_stages", "literal_and_passthrough"):
        stages = _CASES[case]
        program = fused.lower_stages(t, stages)
        got, _, _, _ = emulate_tiles(program, t)
        assert_tables_equal(got, fused.apply_stages(t, stages))


@pytest.mark.parametrize("n", _SIZES)
def test_tile_model_fused_probe(n):
    t = _seeded(n)
    stages, probe = _probe_case(t)
    program = fused.lower_stages(t, stages, probe_keys=probe["probe_keys"])
    got, _, found, bidx = emulate_tiles(
        program, t, probe=(probe["tk"].numpy(), probe["tv"].numpy(),
                           probe["max_probes"], -1))
    want = fused.apply_stages(t, stages)
    wf, wb = fused.apply_probe(want, probe)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(found, wf.numpy())
    np.testing.assert_array_equal(bidx, wb.numpy())
    if n >= 1024:
        assert wf.any() and (~wf).any()


@pytest.mark.parametrize("n", _SIZES)
def test_tile_model_batch_program(n):
    """Three lanes of a two-filter program: lane 1's first filter passes no
    row, so every warp skips it at the second loop; lane 2 is dead in the
    rows from 2048 only."""
    t = _seeded(n, seed=3)
    dtypes, values = [], []
    stages = [(batch._parameterize(col("i") > lit(0), dtypes, values),
               (("i", col("i")), ("x", col("f") * col("g")),
                ("d", col("d")))),
              (batch._parameterize(col("x") < lit(2.5), dtypes, values),
               (("s", col("x") + lit(1.0)), ("i", col("i"))))]
    params = (torch.tensor([3, 2 ** 31 - 1, -60], dtype=torch.int32),
              torch.tensor([2.5, 0.0, 1e9], dtype=torch.float32))
    if n > 2048:
        t.columns["i"][2048:].clamp_(max=-61)
    program = fused.lower_stages(t, stages, batch=True)
    got, masks, _, _ = emulate_tiles(program, t, params, 3)
    want, want_masks = fused.apply_batched_stages(t, stages, params, 3)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())
    assert not want_masks[1].any()


@pytest.mark.parametrize("n", [0, 3, 5000, 999_999])
@pytest.mark.parametrize("shape", ["point", "global"])
def test_tile_model_serving_programs(shape, n):
    t, stages, params = _serving(shape, 32)
    # the shape's columns at n rows: the morsel repeated
    cols = {c: np.resize(a.numpy(), n) for c, a in t.columns.items()}
    big = TorchTable({c: torch.from_numpy(np.ascontiguousarray(a))
                      for c, a in cols.items()},
                     torch.from_numpy(np.arange(n) % 9 != 4), t.schema)
    program = fused.lower_stages(big, stages, batch=True)
    got, masks, _, _ = emulate_tiles(program, big, params, 32)
    want, want_masks = fused.apply_batched_stages(big, stages, params, 32)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())


# ---------------------------------------------------------------------------
# the plan's shared memory, its checks, and the reference
# ---------------------------------------------------------------------------

def _wide(n_cols: int, n_rows: int = 2100):
    """n_cols int32 columns c0.., each projected plus the next: a program
    with n_cols loads and n_cols computed slots."""
    rng = np.random.default_rng(n_cols)
    data = {f"c{k}": rng.integers(-1000, 1000, n_rows).astype(np.int32)
            for k in range(n_cols)}
    t = TorchTable.from_numpy(data, {k: port_dtypes.INT32 for k in data},
                              device="cpu")
    stages = [(None, tuple((f"s{k}", col(f"c{k}") + col(f"c{(k + 1) % n_cols}"))
                           for k in range(n_cols)))]
    return t, stages


@pytest.mark.parametrize("n_cols", [6, 24])
def test_wide_program_fits_shared_memory(n_cols):
    """24 loaded columns and 24 computed slots (48 registers, kMaxRegs) need
    more than 48 KB, and more than two load stages fit: the plan falls back
    to one stage and stays under kMaxSmem."""
    t, stages = _wide(n_cols)
    raw = fused.lower_registers(t, stages)
    program = fused.assign_slots(raw)
    _check_slots(raw, program)
    plan = program.plan
    assert program.n_vec == 2 * n_cols
    assert plan.stage_bytes == LIM["kTileRows"] * (1 + 4 * n_cols)
    two = (16 * len(plan.code) + plan.comp_bytes + 2 * plan.stage_bytes)
    assert plan.stages == (2 if two <= LIM["kMaxSmem"] else 1)
    assert plan.smem_bytes() > 48 * 1024
    if n_cols == 24:
        assert raw.n_regs == LIM["kMaxRegs"] and plan.stages == 1
    got, _, _, _ = emulate_tiles(program, t)
    assert_tables_equal(got, fused.apply_stages(t, stages))


def test_plan_layout_is_what_the_kernel_checks():
    """Every operand of the tile code lies inside its region (the checks of
    read_plan in fused_interp.cuh), offsets are 16-byte aligned, and the
    packed header says what the plan holds."""
    t = _seeded(100)
    shift, low = LIM["kKindShift"], (1 << LIM["kKindShift"]) - 1
    rows = LIM["kTileRows"]
    for case, stages in _CASES.items():
        plan = fused.lower_stages(t, stages).plan
        packed = plan.packed.tolist()
        assert packed[:7] == [len(plan.code), len(plan.uniform),
                              len(plan.loads), plan.n_uniform, plan.stages,
                              plan.stage_bytes, plan.comp_bytes]
        assert len(packed) == LIM["kPlanHeader"] + 4 * (
            len(plan.code) + len(plan.uniform) + len(plan.loads))
        for op, dst, a, b in plan.code:
            regs = fused._reads(op)
            fields = [x for f, x in zip((2, 3), (a, b)) if f in regs]
            if op in fused._ALU:
                fields += [b, dst]
            for e in fields:
                kind, off = e >> shift, e & low
                if kind == LIM["kKindUniform"]:
                    assert off < plan.n_uniform, case
                    continue
                assert off % 16 == 0, case
                if kind == LIM["kKindComp"]:
                    assert off + 4 * rows <= plan.comp_bytes, case
                else:
                    width = 4 if kind == LIM["kKindRing32"] else 1
                    assert rows <= off <= plan.stage_bytes - width * rows, \
                        case
        # the slots of the stage do not overlap
        spans = sorted((o, o + w * rows) for _, w, o in plan.loads)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_a_program_without_slots_is_refused():
    t = _seeded(100)
    raw = fused.lower_registers(t, _CASES["arith_f32"])
    with pytest.raises(ValueError, match="slots"):
        fused._packed(raw, "fused_morsel_program")


def test_tile_model_matches_reference_pallas():
    """The same seeded morsel through the reference's Pallas kernel in
    interpret mode and through the tile model, capacity ragged (3100
    rows): bit for bit."""
    data = seeded_columns(3000, seed=8)
    ref_schema = {k: getattr(rdt, v.name.upper())
                  for k, v in SEEDED_SCHEMA.items()}
    ref_t = DeviceTable.from_numpy(data, ref_schema, capacity=3100)
    port_t = TorchTable.from_numpy(data, SEEDED_SCHEMA, capacity=3100,
                                   device="cpu")
    ref_cases = stage_cases(ref_col, ref_lit, ref_date_lit)
    for case in ("arith_f32", "bool_logic", "three_stages"):
        want, _, _ = ref_fused.fused_morsel_program(ref_t, ref_cases[case],
                                                    interpret=True)
        program = fused.lower_stages(port_t, to_port(ref_cases[case]))
        got, _, _, _ = emulate_tiles(program, port_t)
        np.testing.assert_array_equal(got.validity.numpy(),
                                      np.asarray(want.validity))
        for name in want.column_names:
            a, b = got.columns[name].numpy(), np.asarray(want.columns[name])
            if a.dtype.kind == "f":
                # XLA may reassociate; the reference's own tolerance
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
