"""Inter-query batching in the PyTorch port against the JAX reference.

The same small queries (the three shapes of the reference's serving
workload: point lookup, filtered global aggregate with a projection,
low-cardinality group-by), made from one seed, go through both engines:
``extract_shape`` signatures and parameters, ``fused_batch_program`` (the
port's plain version against the reference's Pallas kernel in interpret
mode), the batched lowering run by the emulator in ``torch_diff`` against
the plain version, the stacked aggregation, and ``run_batch`` through
``Driver.collect_batch`` member by member with equal dispatch counts.

Tolerances: keys, integers, counts, masks and validity exact; float sums
rtol 1e-5 (the reference's own for stacked against serial on the CPU).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as ref_batch
from repro.core import fused as ref_fused
from repro.core.builder import QueryBuilder as RefQB
from repro.core.driver import Driver as RefDriver
from repro.core.dtypes import DType as RefDType
from repro.core.expr import col as ref_col
from repro.core.session import Session as RefSession
from repro.core.table import DeviceTable
from repro.kernels import ops as ref_ops
from repro.kernels import segmented_agg as ref_segagg
from repro.tpch import dbgen as ref_dbgen

from torch_diff import (SEEDED_SCHEMA, assert_tables_equal, emulate_batch,
                        port_catalog, seeded_columns, stage_cases)

from repro_torch.core import batch
from repro_torch.core import fused
from repro_torch.core.builder import QueryBuilder
from repro_torch.core.driver import Driver
from repro_torch.core.expr import col, date_lit, lit
from repro_torch.core.session import Session
from repro_torch.core.table import TorchTable
from repro_torch.kernels import segmented_agg as segagg

SF = 0.005
BATCH_ROWS = 16384
SHAPES = ("point", "global", "group")
# a morsel that is no multiple of the kernels' 1024-row block
MORSEL_ROWS = 5000


@functools.lru_cache(maxsize=1)
def dataset():
    data = ref_dbgen.generate(sf=SF)
    return data, ref_dbgen.load_catalog(sf=SF), port_catalog(data)


def _builder(qb, c, catalog, shape, value):
    """One query of ``shape`` with literal ``value``, built with either
    package's ``QueryBuilder``/``col``."""
    if shape == "point":
        return (qb.scan(catalog, "orders").filter(c("o_orderkey") == int(value))
                .project("o_orderkey", "o_totalprice"))
    if shape == "global":
        return (qb.scan(catalog, "lineitem")
                .filter(c("l_quantity") < float(value))
                .project(rev=c("l_extendedprice") * c("l_discount"))
                .agg(total=("sum", "rev"), n=("count", None)))
    if shape == "group":
        return (qb.scan(catalog, "lineitem")
                .filter(c("l_quantity") < float(value))
                .group_by("l_returnflag")
                .agg(total=("sum", "l_extendedprice"), n=("count", None)))
    # every aggregate kind over float and int columns, two keys
    return (qb.scan(catalog, "lineitem")
            .filter((c("l_quantity") < float(value))
                    & (c("l_linenumber") >= 2))
            .group_by("l_returnflag", "l_linestatus")
            .agg(lo=("min", "l_extendedprice"), hi=("max", "l_discount"),
                 m=("avg", "l_quantity"), s=("sum", "l_linenumber"),
                 mn=("min", "l_linenumber"), n=("count", None)))


def _values(shape, n):
    """``n`` distinct literals for ``shape``'s member lanes."""
    if shape == "point":
        keys = dataset()[0]["orders"]["o_orderkey"]
        # rows 7k + 1 of the morsel: live (every seventh row from 3 is dead)
        return [int(keys[(i * 203 + 1) % 4900]) for i in range(n)]
    return [2.0 + i for i in range(n)]


def _shapes(shape, n):
    """(reference shapes, port shapes) of ``n`` members of ``shape``."""
    _, ref_cat, cat = dataset()
    vals = _values(shape, n)
    ref = [ref_batch.extract_shape(
        _builder(RefQB, ref_col, ref_cat, shape, v).optimized()) for v in vals]
    port = [batch.extract_shape(
        _builder(QueryBuilder, col, cat, shape, v).optimized()) for v in vals]
    return ref, port


def _assert_columns_equal(ref: dict, got: dict, label: str) -> None:
    assert set(ref) == set(got), f"{label}: column sets differ"
    for c in ref:
        r, g = np.asarray(ref[c]), np.asarray(got[c])
        assert r.shape == g.shape, f"{label}.{c}: {r.shape} != {g.shape}"
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{label}.{c}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{label}.{c}")


def _morsel(program):
    """The first MORSEL_ROWS rows of the program's table, every seventh row
    dead: (reference DeviceTable, port TorchTable)."""
    data, ref_cat, cat = dataset()
    cols = list(program.columns)
    host = {c: np.asarray(data[program.table][c][:MORSEL_ROWS]) for c in cols}
    valid = np.arange(MORSEL_ROWS) % 7 != 3
    ref_schema = ref_cat.get(program.table).schema
    schema = cat.get(program.table).schema
    ref = DeviceTable({c: jnp.asarray(a) for c, a in host.items()},
                      jnp.asarray(valid), {c: ref_schema[c] for c in cols})
    port = TorchTable({c: torch.from_numpy(a.copy()).to(
                          schema[c].torch_dtype()) for c, a in host.items()},
                      torch.from_numpy(valid), {c: schema[c] for c in cols})
    return ref, port


def _params(program, values_per_slot, jax_side: bool):
    out = []
    for d, vals in zip(program.param_dtypes, values_per_slot):
        host = np.asarray(vals, dtype=d.np_dtype())
        out.append(jnp.asarray(host) if jax_side
                   else torch.from_numpy(host).to(d.torch_dtype()))
    return tuple(out)


def _slot_values(shapes):
    return [[s.params[i] for s in shapes]
            for i in range(len(shapes[0].params))]


# ---------------------------------------------------------------------------
# shape extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_extract_shape_matches_reference(shape):
    ref, port = _shapes(shape, 2)
    for r, p in zip(ref, port):
        assert p is not None and r is not None
        assert p.program.sig == r.program.sig
        assert ([d.name for d in p.program.param_dtypes]
                == [d.name for d in r.program.param_dtypes])
        assert p.params == r.params
        assert p.program.group_keys == r.program.group_keys
        assert p.program.max_groups == r.program.max_groups
        assert p.program.user_specs == r.program.user_specs
    # literal-only variants intern to ONE program; the literals come back
    # as per-member parameters
    assert port[0].program is port[1].program
    assert port[0].params != port[1].params
    assert len(port[0].params) == len(port[0].program.param_dtypes) == 1


def _unsupported(catalog):
    li = QueryBuilder.scan(catalog, "lineitem").filter(col("l_quantity") < 5.0)
    orders = QueryBuilder.scan(catalog, "orders")
    return {
        "join": li.join(orders, ["l_orderkey"], ["o_orderkey"])
                  .agg(n=("count", None)),
        "order_by": li.project("l_orderkey").order_by("l_orderkey"),
        "limit": li.project("l_orderkey").limit(5),
        "distinct": li.distinct("l_returnflag"),
    }


@pytest.mark.parametrize("plan", ["join", "order_by", "limit", "distinct"])
def test_extract_shape_rejects_unsupported_plans(plan):
    cat = dataset()[2]
    assert batch.extract_shape(_unsupported(cat)[plan].optimized()) is None


def test_stacked_group_capacity_bound():
    limit = segagg.STACKED_GROUP_LIMIT
    assert limit == ref_segagg.STACKED_GROUP_LIMIT
    for mg in [1, 2, 3, 7, 16, 100, 4096, limit // 2, limit, limit + 1,
               limit * 4]:
        cap = segagg.stacked_group_capacity(mg)
        assert cap == ref_segagg.stacked_group_capacity(mg)
        assert cap >= 1
        assert cap & (cap - 1) == 0, f"capacity {cap} not a power of two"
        if cap > 1:
            assert cap * mg <= limit
            assert 2 * cap > limit // mg
    assert segagg.stacked_group_capacity(limit + 1) == 1
    assert segagg.stacked_group_capacity(limit * 8) == 1
    with pytest.raises(ValueError):
        segagg.stacked_group_capacity(0)


# ---------------------------------------------------------------------------
# the kernel's function: port (plain) against the reference (interpret)
# ---------------------------------------------------------------------------

# 65 and 128: more lanes than the CUDA kernel's 64-bit lane word, which
# the card runs as ceil(B / 64) launches
@pytest.mark.parametrize("lanes", [1, 4, 16, 65, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_batch_program_matches_reference(shape, lanes):
    ref_shapes, shapes = _shapes(shape, lanes)
    rprog, prog = ref_shapes[0].program, shapes[0].program
    ref_t, t = _morsel(prog)
    slots = _slot_values(shapes)
    with ref_ops.use_pallas():
        want, want_masks = ref_fused.fused_batch_program(
            ref_t, _params(rprog, slots, True),
            lambda tb, pr: ref_batch.apply_batched_stages(
                tb, rprog.pre_stages, pr, lanes), lanes)
    got, masks = fused.fused_batch_program(t, prog.pre_stages,
                                           _params(prog, slots, False), lanes)
    assert masks.shape == (lanes, MORSEL_ROWS) and masks.dtype == torch.bool
    np.testing.assert_array_equal(masks.numpy(), np.asarray(want_masks))
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    assert sorted(got.column_names) == sorted(want.column_names)
    for c in want.column_names:
        np.testing.assert_array_equal(got.columns[c].numpy(),
                                      np.asarray(want.columns[c]), err_msg=c)
    assert masks.any(dim=1).all(), "a lane with no live row tests little"


@pytest.mark.parametrize("lanes", [1, 4, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_batch_lowering_emulates_plain(shape, lanes):
    _, shapes = _shapes(shape, lanes)
    prog = shapes[0].program
    _, t = _morsel(prog)
    params = _params(prog, _slot_values(shapes), False)
    program = fused.lower_stages(t, prog.pre_stages, batch=True)
    assert program.batch and program.code.shape[0] <= fused.LIMITS["kMaxInstr"]
    got, masks = emulate_batch(program, t, params, lanes)
    want, want_masks = fused.apply_batched_stages(t, prog.pre_stages, params,
                                                  lanes)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())
    # pass-through columns are the input tensors, never copied
    for name, alias in zip(program.out_names, program.out_alias):
        if alias is not None:
            assert got.columns[name] is t.columns[alias]
    # and the kernel reads only what a predicate or a stored output needs
    assert set(program.in_names) == _READS[shape]


_READS = {"point": {"o_orderkey"},
          "global": {"l_quantity", "l_extendedprice", "l_discount"},
          "group": {"l_quantity"}}


def test_batch_lowering_renamed_pass_through():
    """A column projected under a new name is not loaded for the
    projection: the output aliases the input, and a later stage's
    predicate on the new name reads the input column."""
    t = TorchTable.from_numpy(seeded_columns(3000, seed=2), SEEDED_SCHEMA,
                              device="cpu")
    t = t.filter(torch.from_numpy(np.arange(3000) % 3 != 1))
    dtypes, values = [], []
    first = batch._parameterize(col("j") > lit(0), dtypes, values)
    second = batch._parameterize(col("x") < lit(5.0), dtypes, values)
    stages = [(first, (("x", col("f")), ("y", col("i")), ("k", col("j")))),
              (second, (("x", col("x")), ("y", col("y"))))]
    params = (torch.tensor([0, -2, 3], dtype=torch.int32),
              torch.tensor([5.0, -1.0, 40.0], dtype=torch.float32))
    program = fused.lower_stages(t, stages, batch=True)
    assert program.in_names == ("j", "f")
    assert program.out_alias == ("f", "i")
    got, masks = emulate_batch(program, t, params, 3)
    want, want_masks = fused.apply_batched_stages(t, stages, params, 3)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())
    assert got.columns["y"] is t.columns["i"]


def _lane_value(value, dtype, lane):
    if dtype.name == "bool":
        return bool(value) != bool(lane % 2)
    if dtype.name in ("float32", "float64"):
        return float(value) + 0.5 * lane
    if dtype.name == "date32":
        return int(value) + 30 * lane
    return int(value) + lane


_CASES = stage_cases(col, lit, date_lit)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_batch_lowering_stage_cases(case):
    """Every stage case of the fused kernel's tests with its filter
    literals parameterized, five lanes of distinct parameters: the lowered
    batch program, emulated, equals the plain version bit for bit."""
    lanes = 5
    data = seeded_columns(3000, seed=5)
    t = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    t = t.filter(torch.from_numpy(np.arange(3000) % 5 != 2))
    dtypes, values, stages = [], [], []
    for filter_expr, projections in _CASES[case]:
        if filter_expr is not None:
            filter_expr = batch._parameterize(filter_expr, dtypes, values)
        stages.append((filter_expr, projections))
    params = tuple(
        torch.tensor([_lane_value(v, d, b) for b in range(lanes)],
                     dtype=d.torch_dtype())
        for d, v in zip(dtypes, values))
    program = fused.lower_stages(t, stages, batch=True)
    assert (program.code[:, 0] == fused.OPS["PARAM"]).sum() >= len(dtypes)
    got, masks = emulate_batch(program, t, params, lanes)
    want, want_masks = fused.apply_batched_stages(t, stages, params, lanes)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())


def test_batch_lowering_keeps_loop_registers_inside():
    """A projection after a filter whose body first emits a constant and a
    comparison must not reuse them: the emulator drops every register the
    body wrote, so a read after the loop would fail."""
    t = TorchTable.from_numpy(seeded_columns(100, seed=1), SEEDED_SCHEMA,
                              device="cpu")
    dtypes, values = [], []
    pred = batch._parameterize(col("i").isin([0, 1]) | (col("j") > lit(2)),
                               dtypes, values)
    stages = [(pred, (("x", col("j") > lit(2)), ("y", col("i") + lit(0))))]
    params = (torch.tensor([2, -3], dtype=torch.int32),)
    program = fused.lower_stages(t, stages, batch=True)
    got, masks = emulate_batch(program, t, params, 2)
    want, want_masks = fused.apply_batched_stages(t, stages, params, 2)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())


# ---------------------------------------------------------------------------
# stacked aggregation and run_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["global", "group", "kinds"])
def test_stacked_aggregate_matches_reference(shape):
    """The same projected morsel and the same masks through both engines'
    stacked aggregation: random member masks (the stacked segment ids come
    out unsorted) with two members that have no live row."""
    lanes = 8
    ref_shapes, shapes = _shapes(shape, lanes)
    rprog, prog = ref_shapes[0].program, shapes[0].program
    _, t = _morsel(prog)
    out, _ = fused.fused_batch_program(
        t, prog.pre_stages, _params(prog, _slot_values(shapes), False), lanes)
    rng = np.random.default_rng(17)
    masks = (rng.random((lanes, out.capacity)) < 0.4) & out.validity.numpy()
    masks[2] = False
    masks[5] = False
    ref_t = DeviceTable(
        {c: jnp.asarray(a.numpy()) for c, a in out.columns.items()},
        jnp.asarray(out.validity.numpy()),
        {c: RefDType(d.name, d.width, d.dictionary)
         for c, d in out.schema.items()})
    with ref_ops.use_pallas():
        r_keys, r_aggs, r_emit = ref_batch._stacked_aggregate(
            ref_t, jnp.asarray(masks), rprog, lanes)
    keys, aggs, emit = batch._stacked_aggregate(out, torch.from_numpy(masks),
                                                prog, lanes)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(r_emit))
    if prog.group_keys:     # members with no live row emit no group
        assert not emit[2].any() and not emit[5].any()
    assert sorted(keys) == sorted(r_keys) and sorted(aggs) == sorted(r_aggs)
    for k in keys:
        np.testing.assert_array_equal(keys[k].numpy(), np.asarray(r_keys[k]))
    live = emit.numpy()
    for name in aggs:
        got, want = aggs[name].numpy(), np.asarray(r_aggs[name])
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got[live], want[live], err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_run_batch_matches_reference(shape):
    """Six members through ``Driver.collect_batch`` at eight lanes in both
    engines (the reference under its pallas backend): member by member
    equal, with equal ``kernel_dispatch``."""
    _, ref_cat, cat = dataset()
    ref_shapes, shapes = _shapes(shape, 6)
    ref_driver = RefDriver(RefSession(ref_cat, batch_rows=BATCH_ROWS,
                                      kernel_backend="pallas").context())
    want = ref_driver.collect_batch(ref_shapes, lanes=8)
    driver = Driver(Session(cat, batch_rows=BATCH_ROWS,
                            device="cpu").context())
    got = driver.collect_batch(shapes, lanes=8)
    assert len(got) == len(want) == 6
    for b, (g, w) in enumerate(zip(got, want)):
        _assert_columns_equal(w, g, f"{shape} member {b}")
    assert (driver.executor_stats()["kernel_dispatch"]
            == ref_driver.executor_stats()["kernel_dispatch"])
    assert sum(len(next(iter(g.values()))) for g in got) > 0


def test_interning_and_lowering_are_thread_safe():
    """Scheduler workers extract shapes and lower programs concurrently:
    16 threads with a short switch interval must all get the one interned
    program and the one lowered program per input signature."""
    import sys
    import threading

    cat = dataset()[2]
    plans = [_builder(QueryBuilder, col, cat, "global", 2.0 + i).optimized()
             for i in range(16)]
    batch.clear_programs()
    _, t = _morsel(batch.extract_shape(plans[0]).program)
    batch.clear_programs()
    got, errors = [], []

    def worker(i):
        try:
            shape = batch.extract_shape(plans[i])
            got.append((shape.program, shape.program.lowered(t)))
        except Exception as exc:  # noqa: BLE001 -- asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(got) == 16
    assert len({id(p) for p, _ in got}) == 1
    assert len({id(lw) for _, lw in got}) == 1
