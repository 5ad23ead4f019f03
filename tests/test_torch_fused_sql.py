"""The fused kernels' SQL instructions on the CPU: YEAR (``EXTRACT(YEAR
...)``) and BYTESMATCH (``LIKE`` over a fixed-width bytes column), a bytes
column carried through a stage untouched, and a run too large for one
program cut into consecutive ones (``fused.lower_split``).

Each lowered program runs through the emulators of ``torch_diff``
(``emulate``, ``emulate_batch`` and the tile model ``emulate_tiles``),
which follow the CUDA kernels' semantics, and must equal the plain version
(``apply_stages``, ``apply_batched_stages``) bit for bit; the plain
version's ``Year`` and ``BytesMatch`` must equal the reference's.
"""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from torch_diff import (assert_tables_equal, emulate, emulate_batch,
                        emulate_tiles, match_numpy, port_schema, to_port,
                        year_numpy)

from repro.core import dtypes as rdt
from repro.core import expr as rexpr
from repro.core.table import DeviceTable
from repro_torch.core import batch
from repro_torch.core import fused
from repro_torch.core.expr import BytesMatch, IsIn, Year, col, lit
from repro_torch.core.table import TorchTable

I32 = np.iinfo(np.int32)
W = 12


def _year_days() -> np.ndarray:
    """Every year start from 1969 to 2040, a day either side, and the
    int32 extremes."""
    starts = [(np.datetime64(f"{y}-01-01") - np.datetime64("1970-01-01"))
              .astype(int) for y in range(1969, 2042)]
    days = [d + k for d in starts for k in (-1, 0, 1)]
    return np.array(days + [I32.min, I32.min + 1, I32.max - 1, I32.max, -1,
                            0], np.int32)


def _table(days, rows, valid=None):
    n = len(days)
    data = {"d": days, "s": rows, "i": np.arange(n, dtype=np.int32)}
    schema = {"d": rdt.DATE32, "s": rdt.bytes_(rows.shape[1]),
              "i": rdt.INT32}
    t = TorchTable.from_numpy(data, port_schema(schema), device="cpu")
    if valid is not None:
        t = t.filter(torch.from_numpy(valid))
    ref = DeviceTable.from_numpy(data, schema)
    return t, ref


def _rows(strings, width=W) -> np.ndarray:
    """Space-padded fixed-width rows, as dbgen stores a bytes column."""
    return np.array([list(s.encode().ljust(width)[:width]) for s in strings],
                    np.uint8).reshape(len(strings), width)


def _check_all(t, stages):
    """The program of ``stages`` through the emulator and the tile model
    against ``apply_stages``, bit for bit."""
    program = fused.lower_stages(t, stages)
    want = fused.apply_stages(t, stages)
    assert_tables_equal(emulate(program, t), want)
    assert_tables_equal(emulate_tiles(program, t)[0], want)
    return program, want


def test_year_is_exact_at_every_year_start_and_the_extremes():
    days = _year_days()
    t, ref = _table(days, _rows(["x"] * len(days)))
    stages = [(None, (("y", Year(col("d"))), ("d", col("d"))))]
    program, want = _check_all(t, stages)
    assert fused.OPS["YEAR"] in program.code[:, 0].tolist()
    ref_year = np.asarray(rexpr.Year(rexpr.col("d")).evaluate(ref))
    np.testing.assert_array_equal(want.columns["y"].numpy(), ref_year)
    np.testing.assert_array_equal(year_numpy(days), ref_year)
    # the clamps: every day before 1970 is 1969, from 2039 on 2039
    assert ref_year[days < 0].tolist() == [1969] * int((days < 0).sum())
    assert set(ref_year[days >= 25202].tolist()) == {2039}
    # a year of a uniform operand (a literal) is evaluated in the uniform
    # table; a filter on a year compares it
    stages = [(Year(col("d")) == lit(1995), (("c", Year(lit(9500))),
                                              ("i", col("i"))))]
    _check_all(t, stages)


_EDGE_ROWS = ["", "ab", "special requests", "special  requestsx",
              "requests special", "aaa", "aaaa", "abcab", "xxxxxxxxxxab",
              "ab          ", "   ab", "Customer Co"]
_EDGE_MATCHES = [
    BytesMatch(col("s"), ("a",), "contains"),
    BytesMatch(col("s"), ("aa", "aa"), "contains"),     # parts may not overlap
    BytesMatch(col("s"), ("ab", "ab"), "contains"),
    BytesMatch(col("s"), ("special", "requests"), "contains"),
    BytesMatch(col("s"), ("requests", "special"), "contains"),
    BytesMatch(col("s"), ("ab",), "endswith"),          # a part at the end
    BytesMatch(col("s"), (" ab",), "endswith"),
    BytesMatch(col("s"), ("ab",), "startswith"),
    BytesMatch(col("s"), ("x" * (W + 1),), "contains"),  # longer than W
    BytesMatch(col("s"), ("x" * (W + 1),), "endswith"),
    BytesMatch(col("s"), ("xxxxxxxxxxab",), "contains"),  # exactly W
    BytesMatch(col("s"), (" ",), "endswith"),           # all spaces: length 0
]


@pytest.mark.parametrize("k", range(len(_EDGE_MATCHES)))
def test_bytesmatch_edge_rows(k):
    e = _EDGE_MATCHES[k]
    rows = _rows(_EDGE_ROWS)
    t, ref = _table(np.zeros(len(rows), np.int32), rows)
    program, want = _check_all(t, [(e, (("i", col("i")),))])
    # the record in the pool, and the plain version against the reference
    assert program.pool[0] == fused._MATCH_MODES[e.mode]
    ref_e = rexpr.BytesMatch(rexpr.col("s"), e.parts, e.mode)
    want_mask = np.asarray(ref_e.evaluate(ref))
    np.testing.assert_array_equal(e.evaluate(t).numpy(), want_mask)
    np.testing.assert_array_equal(want.validity.numpy(), want_mask)
    np.testing.assert_array_equal(match_numpy(rows, program.pool, 0),
                                  want_mask.astype(np.uint32))


def test_bytesmatch_pool_is_shared_and_laid_out_in_the_plan():
    rows = _rows(["special requests", "ab"] * 3)
    t, _ = _table(np.zeros(6, np.int32), rows)
    like = BytesMatch(col("s"), ("special", "requests"), "contains")
    stages = [(like & ~BytesMatch(col("s"), ("ab",), "startswith"),
               (("m", like), ("s", col("s"))))]
    program, _ = _check_all(t, stages)
    # the same pattern twice is one record; the bytes column is read by
    # BYTESMATCH only and passes through to the output
    assert program.pool == (bytes([0, 2, 7]) + b"special" + bytes([8])
                            + b"requests" + bytes([1, 1, 2]) + b"ab")
    plan = program.plan
    assert plan.pool_bytes == len(program.pool)
    groups = -(-len(program.pool) // 16)
    assert plan.packed[7].item() == len(program.pool)
    tail = plan.packed[len(plan.packed) - 4 * groups:].numpy()
    assert tail.astype("<i4").tobytes()[:len(program.pool)] == program.pool
    assert plan.smem_bytes() == (16 * len(plan.code) + 16 * groups
                                 + plan.comp_bytes
                                 + plan.stages * plan.stage_bytes
                                 + 4 * plan.n_uniform)
    assert dict(zip(program.out_names, program.out_alias))["s"] == "s"


_ALPHABET = st.sampled_from(list("ab "))


@settings(max_examples=60, deadline=None)
@given(strings=st.lists(st.text(_ALPHABET, max_size=W), min_size=1,
                        max_size=40),
       parts=st.lists(st.text(st.sampled_from(list("ab")), min_size=1,
                              max_size=4), min_size=1, max_size=3),
       mode=st.sampled_from(["contains", "startswith", "endswith"]),
       days=st.lists(st.integers(I32.min, I32.max), min_size=40,
                     max_size=40),
       seed=st.integers(0, 1000))
def test_lowered_programs_equal_plain_on_random_rows(strings, parts, mode,
                                                     days, seed):
    rows = _rows(strings)
    n = len(rows)
    valid = np.random.default_rng(seed).random(n) < 0.8
    t, _ = _table(np.array(days[:n], np.int32), rows, valid)
    e = BytesMatch(col("s"), tuple(parts), mode)
    stages = [(e | (Year(col("d")) > lit(2000)),
               (("y", Year(col("d"))), ("s", col("s")), ("m", e)))]
    _check_all(t, stages)
    # a stacked predicate: the year's bound is each lane's parameter
    dtypes, values = [], []
    pred = batch._parameterize(e & (Year(col("d")) >= lit(1990)), dtypes,
                               values)
    params = tuple(torch.tensor([1985 + 5 * b for b in range(3)],
                                dtype=torch.int32) for _ in dtypes)
    program = fused.lower_stages(t, [(pred, (("y", Year(col("d"))),))],
                                 batch=True)
    want, want_masks = fused.apply_batched_stages(
        t, [(pred, (("y", Year(col("d"))),))], params, 3)
    for got, masks in (emulate_batch(program, t, params, 3),
                       emulate_tiles(program, t, params, 3)[:2]):
        assert_tables_equal(got, want)
        np.testing.assert_array_equal(masks.numpy(), want_masks.numpy())


def _split_case():
    """Q2's unoptimized part filter: an IsIn of 30 values after an
    equality, over columns that include a bytes one carried through."""
    rng = np.random.default_rng(2)
    n = 3000
    data = {c: rng.integers(0, 150, n).astype(np.int32)
            for c in ("p_partkey", "p_mfgr", "p_brand", "p_type", "p_size",
                      "p_container")}
    data["p_name"] = rng.integers(97, 100, (n, 9)).astype(np.uint8)
    data["p_retailprice"] = rng.normal(900, 100, n).astype(np.float32)
    schema = {c: rdt.INT32 for c in data}
    schema["p_name"] = rdt.bytes_(9)
    schema["p_retailprice"] = rdt.FLOAT32
    t = TorchTable.from_numpy(data, port_schema(schema), device="cpu")
    t = t.filter(torch.from_numpy(rng.random(n) < 0.9))
    stages = [(col("p_size") == lit(15), None),
              (IsIn(col("p_type"), tuple(range(0, 150, 5))), None)]
    return t, stages


def test_split_run_equals_the_unsplit_plain_version():
    t, stages = _split_case()
    with pytest.raises(fused.KernelLimitError):
        fused.lower_stages(t, stages)
    runs = fused.lower_split(t, stages)
    assert len(runs) > 1
    cur = t
    for part, program in runs:
        assert program.n_regs <= fused.LIMITS["kMaxRegs"]
        assert program.code.shape[0] <= fused.LIMITS["kMaxInstr"]
        assert "p_name" not in program.in_names
        # each program equals the plain version of its own stages
        want_part = fused.apply_stages(cur, part)
        got = emulate(program, cur)
        assert_tables_equal(got, want_part)
        assert_tables_equal(emulate_tiles(program, cur)[0], want_part)
        cur = got
    want = fused.apply_stages(t, stages)
    assert_tables_equal(cur, want)
    assert cur.columns["p_name"] is t.columns["p_name"]
    # a run that fits stays one program
    (only,) = fused.lower_split(t, stages[:1])
    assert only[0] == tuple(stages[:1])


def test_split_refuses_a_stage_no_cut_fits():
    t, _ = _split_case()
    big = col("p_size")
    for k in range(30):                 # one long chain of arithmetic
        big = big * lit(k + 2) + col("p_type")
    with pytest.raises(fused.KernelLimitError):
        fused.lower_split(t, [(big > lit(0), None)])


def test_reference_year_and_match_agree_with_port_plain():
    """The plain versions the kernels are held to are the reference's."""
    days = _year_days()
    rows = _rows(_EDGE_ROWS * 20)[:len(days)]
    t, ref = _table(days, rows)
    np.testing.assert_array_equal(
        Year(col("d")).evaluate(t).numpy(),
        np.asarray(rexpr.Year(rexpr.col("d")).evaluate(ref)))
    for e in _EDGE_MATCHES[:8]:
        got = e.evaluate(t).numpy()
        want = rexpr.BytesMatch(rexpr.col("s"), e.parts, e.mode).evaluate(ref)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert isinstance(to_port(rexpr.Year(rexpr.col("d"))), Year)
