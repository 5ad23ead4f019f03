"""The port's core modules against the JAX reference on the same numpy
inputs: ``Expr`` evaluation (dtypes and promotion), ``TorchTable`` against
``DeviceTable``, and ``lexsort`` / ``group_rows`` / ``segment_agg``
against ``repro.core.relational`` (the latter under the reference's
``pallas`` backend, whose kernels run in interpret mode here)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import port_schema, seeded_columns, to_port  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import relational as ref_rel  # noqa: E402
from repro.core.expr import col, date_lit, lit  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.core.table import concat_tables as ref_concat  # noqa: E402
from repro.core.table import empty_like_schema as ref_empty  # noqa: E402
from repro.kernels.ops import use_pallas  # noqa: E402
from repro_torch.core import relational as rel  # noqa: E402
from repro_torch.core.table import (TorchTable, concat_tables,  # noqa: E402
                                    empty_like_schema)

_SCHEMA = {"i": rdt.INT32, "j": rdt.INT32, "f": rdt.FLOAT32,
           "g": rdt.FLOAT32, "b": rdt.BOOL, "d": rdt.DATE32}


@pytest.fixture(scope="module")
def tables():
    data = seeded_columns(500, seed=5)
    ref = DeviceTable.from_numpy(data, _SCHEMA, capacity=512)
    port = TorchTable.from_numpy(data, port_schema(_SCHEMA), capacity=512,
                                 device="cpu")
    return ref, port


def _same(got, want, exact=True):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    if exact or got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_EXPRS = {
    "i32_add_f32": col("i") + col("f"),
    "i32_mul_wraps": col("i") * col("i"),
    "i32_sub_lit": col("i") - lit(5),
    "lit_minus_f32": lit(1.0) - col("f"),
    "f32_mul": col("f") * col("g"),
    "div_ints": col("i") / col("j"),
    "div_f32_by_int": col("f") / lit(3),
    "lt_i32_f32": col("i") < col("f"),
    "date_ge": col("d") >= date_lit("1995-06-17"),
    "eq_lit": col("j") == 3,
    "ne_f32": col("f") != col("f"),
    "and": (col("i") > 0) & col("b"),
    "or": (col("f") < 0.0) | (col("j") >= 2),
    "not": ~col("b"),
    "neg_i32": -col("i"),
    "neg_f32": -col("f"),
    "isin_int": col("j").isin([1, 2, -3]),
    "isin_float": col("f").isin([0.5, 0.0]),
    "isin_int_vs_float": col("j").isin([1.5, 2.0]),
    "between": col("g").between(-0.5, 0.5),
    "literal_int": lit(7),
    "literal_float": lit(2.5),
    "literal_date": date_lit("1994-01-01"),
}


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_expr_matches_reference(name, tables):
    ref_t, port_t = tables
    e = _EXPRS[name]
    pe = to_port(e)
    _same(pe.evaluate(port_t), e.evaluate(ref_t))
    assert pe.out_dtype(port_t.schema) == to_port(e.out_dtype(ref_t.schema))
    assert pe.references() == e.references()


# ---------------------------------------------------------------------------
# TorchTable against DeviceTable
# ---------------------------------------------------------------------------

def _same_table(got: TorchTable, want: DeviceTable):
    assert sorted(got.column_names) == sorted(want.column_names)
    assert got.capacity == want.capacity
    _same(got.validity, want.validity)
    for n in want.column_names:
        _same(got.columns[n], want.columns[n])
    assert got.schema == port_schema(want.schema)
    host_got, host_want = got.to_numpy(), want.to_numpy()
    for n in host_want:
        np.testing.assert_array_equal(host_got[n], host_want[n])


def _mask(cap, seed):
    m = np.random.default_rng(seed).random(cap) < 0.6
    return jnp.asarray(m), torch.from_numpy(m)


_TABLE_OPS = {
    "from_numpy": lambda t, m, x: t,
    "select": lambda t, m, x: t.select(["f", "i"]),
    "rename": lambda t, m, x: t.rename({"i": "k", "b": "flag"}),
    "with_column": lambda t, m, x: t.with_column("z", t.columns["j"],
                                                 x.INT32),
    "filter": lambda t, m, x: t.filter(m),
    "compact": lambda t, m, x: t.filter(m).compact(),
    "pad_to": lambda t, m, x: t.filter(m).pad_to(700),
    "gather": lambda t, m, x: t.gather(
        x.idx(np.arange(511, -1, -3)), x.mask(np.arange(171) % 4 != 1)),
}


class _Ref:
    INT32 = rdt.INT32

    @staticmethod
    def idx(a):
        return jnp.asarray(a, jnp.int32)

    @staticmethod
    def mask(a):
        return jnp.asarray(a)


class _Port:
    INT32 = to_port(rdt.INT32)

    @staticmethod
    def idx(a):
        return torch.as_tensor(a.copy(), dtype=torch.int32)

    @staticmethod
    def mask(a):
        return torch.as_tensor(a.copy())


@pytest.mark.parametrize("op", sorted(_TABLE_OPS))
def test_table_op_matches_device_table(op, tables):
    ref_t, port_t = tables
    jm, tm = _mask(512, seed=len(op))
    fn = _TABLE_OPS[op]
    # the port always takes the reference's pallas path; its compaction
    # (block_prefix_sum addresses) leaves the dead tail as that path does
    with use_pallas():
        want = fn(ref_t, jm, _Ref)
    _same_table(fn(port_t, tm, _Port), want)


def test_concat_and_empty_match_device_table(tables):
    ref_t, port_t = tables
    jm, tm = _mask(512, seed=1)
    _same_table(concat_tables([port_t, port_t.filter(tm)]),
                ref_concat([ref_t, ref_t.filter(jm)]))
    _same_table(empty_like_schema(port_t.schema, 9, device="cpu"),
                ref_empty(ref_t.schema, 9))
    assert port_t.nbytes() == ref_t.nbytes()
    assert int(port_t.num_valid()) == int(ref_t.num_valid())


# ---------------------------------------------------------------------------
# relational: lexsort, group_rows, segment_agg
# ---------------------------------------------------------------------------

def _sort_inputs(seed, n=400):
    rng = np.random.default_rng(seed)
    a = rng.integers(-3, 3, n).astype(np.int32)
    a[:5] = np.iinfo(np.int32).min
    a[5:9] = np.iinfo(np.int32).max
    f = rng.choice(np.array([-1.5, -0.0, 0.0, 2.0, np.nan, -np.inf, np.inf],
                            np.float32), n)
    b = rng.random(n) < 0.5
    valid = rng.random(n) < 0.8
    return {"a": a, "f": f, "b": b}, valid


_SORTS = {
    "int_asc": (["a"], [False]),
    "int_desc": (["a"], [True]),
    "float_asc": (["f"], [False]),
    "float_desc": (["f"], [True]),
    "mixed": (["a", "f"], [True, False]),
    "three_keys": (["b", "f", "a"], [False, True, True]),
}


@pytest.mark.parametrize("case", sorted(_SORTS))
def test_lexsort_matches_reference(case):
    cols, valid = _sort_inputs(seed=len(case))
    names, desc = _SORTS[case]
    want = ref_rel.lexsort([jnp.asarray(cols[n]) for n in names],
                           jnp.asarray(valid), desc)
    got = rel.lexsort([torch.from_numpy(cols[n]) for n in names],
                      torch.from_numpy(valid), desc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_groups", [64, 8])   # 8: more groups than slots
def test_group_rows_matches_reference(max_groups):
    cols, valid = _sort_inputs(seed=3)
    keys = ["a", "b"]
    want = ref_rel.group_rows([jnp.asarray(cols[k]) for k in keys],
                              jnp.asarray(valid), max_groups)
    got = rel.group_rows([torch.from_numpy(cols[k]) for k in keys],
                         torch.from_numpy(valid), max_groups)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    _same(got.gids, want.gids)
    assert int(got.num_groups) == int(want.num_groups)
    _same(got.group_valid, want.group_valid)
    n = min(int(want.num_groups), max_groups)
    _same(got.key_rows[:n], want.key_rows[:n])


@pytest.mark.parametrize("kind,dtype", [("sum", np.float32), ("sum", np.int32),
                                        ("count", np.float32),
                                        ("min", np.float32), ("max", np.float32),
                                        ("min", np.int32), ("max", np.int32)])
def test_segment_agg_matches_pallas_path(kind, dtype):
    rng = np.random.default_rng(11)
    n, max_groups = 600, 40
    keys = rng.integers(0, 30, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    if dtype == np.int32:
        vals = rng.integers(1 << 28, 1 << 30, n).astype(np.int32)  # wraps
    else:
        vals = rng.normal(0, 5, n).astype(np.float32)
        vals[~valid] = np.nan       # dead rows may hold garbage
    g = ref_rel.group_rows([jnp.asarray(keys)], jnp.asarray(valid), max_groups)
    with use_pallas():
        want = ref_rel.segment_agg(jnp.asarray(vals), g.gids, g.order,
                                   jnp.asarray(valid), max_groups, kind)
    pg = rel.group_rows([torch.from_numpy(keys)], torch.from_numpy(valid),
                        max_groups)
    got = rel.segment_agg(torch.from_numpy(vals), pg.gids, pg.order,
                          torch.from_numpy(valid), max_groups, kind)
    _same(got, want, exact=dtype != np.float32 or kind != "sum")


def test_segment_agg_refuses_minmax():
    # min/max over a bytes column: no kernel takes it (the reference's
    # kernel_kind_ok refuses it too)
    t = torch.zeros(4, dtype=torch.int32)
    b = torch.zeros((4, 3), dtype=torch.uint8)
    for kind in ("min", "max"):
        with pytest.raises(NotImplementedError):
            rel.segment_agg(b, t, t.long(), torch.ones(4, dtype=torch.bool),
                            2, kind)
