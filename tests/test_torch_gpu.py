"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch::

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_diff import (SEEDED_SCHEMA, assert_tables_equal,  # noqa: E402
                        seeded_columns, stage_cases)
from tpch_util import assert_results_match  # noqa: E402

from repro_torch import HostExchange  # noqa: E402
from repro_torch.core import dtypes as port_dtypes  # noqa: E402
from repro_torch.core import fused  # noqa: E402
from repro_torch.core.expr import col, date_lit, lit  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import hash_probe as hp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import segmented_agg as seg  # noqa: E402
from repro_torch.kernels.block_prefix_sum import (  # noqa: E402
    block_prefix_sum, block_prefix_sum_plain)
from repro_torch.kernels.radix_histogram import (  # noqa: E402
    partition_histogram, partition_histogram_plain, radix_histogram,
    radix_histogram_plain)
from repro_torch.launch.mesh import EngineMesh  # noqa: E402
from repro_torch.tpch import dbgen, queries  # noqa: E402

pytestmark = pytest.mark.gpu
_CASES = stage_cases(col, lit, date_lit)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,g", [(1 << 20, 16), (100_000, 9000), (0, 8)])
def test_segmented_kernels_on_card(cuda, n, g):
    rng = np.random.default_rng(n + g)
    gids = torch.from_numpy(np.sort(rng.integers(0, g + 1, n)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    ivals = torch.from_numpy(rng.integers(1 << 29, 1 << 30, n).astype(np.int32))
    ops.reset_launch_counts()
    got = seg.segmented_sum(gids.to(cuda), vals.to(cuda), g).cpu()
    igot = seg.segmented_int_sum(gids.to(cuda), ivals.to(cuda), g).cpu()
    assert ops.launch_counts()["segmented_sum"] == (1 if n else 0)
    np.testing.assert_array_equal(
        igot.numpy(), seg.segmented_int_sum_plain(gids, ivals, g).numpy())
    # float sums in another order: within 1e-4 of the group's sum of |v|
    want = seg.segmented_sum_plain(gids, vals, g).numpy()
    scale = seg.segmented_sum_plain(gids, vals.abs(), g).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 1e-4 * scale + 1e-6)


# (case, n, G, ids' row offset, values' row offset): every id dead, the
# scalar tail (n % 4 of 1-3), bases 1-3 rows past a 16-byte boundary (ids
# and values misaligned differently, or alike), the largest shared-partials
# G and the first global one, a merge's 2^24 sorted rows with a dead tail
_SEG_EDGES = [("all_dead", 100_003, 1000, 0, 0),
              ("tail", 100_001, 500, 0, 0), ("tail", 100_002, 500, 0, 0),
              ("tail", 100_003, 500, 0, 0),
              ("offset", 100_001, 700, 1, 2), ("offset", 100_001, 700, 3, 0),
              ("offset", 100_001, 700, 2, 2), ("offset", 5, 700, 1, 3),
              ("unsorted", 1 << 20, 8192, 0, 0),
              ("unsorted", 1 << 20, 8193, 0, 0),
              ("dead_tail", 1 << 24, 1 << 23, 0, 0)]


@pytest.mark.parametrize("case,n,g,id_off,val_off", _SEG_EDGES)
def test_segmented_kernels_on_card_edges(cuda, case, n, g, id_off, val_off):
    rng = np.random.default_rng(n + g + id_off + 4 * val_off)
    if case == "all_dead":
        gids = rng.choice(np.array([-1, -5, g, g + 7, 2 ** 31 - 1]), n)
    elif case == "dead_tail":
        gids = np.full(n, g)
        gids[:40_000] = np.sort(rng.integers(0, g, 40_000))
    else:
        gids = rng.integers(-1, g + 2, n)
        gids[-3:] = [1, 2, 3]               # the tail's rows live
    gids = gids.astype(np.int32)
    vals = rng.normal(0, 1, n).astype(np.float32)
    ivals = rng.integers(1 << 29, 1 << 30, n).astype(np.int32)

    def at(a, off):
        """``a`` on the card, its base ``off`` rows past a 16-byte boundary."""
        buf = torch.empty(n + 4, dtype=torch.from_numpy(a).dtype, device=cuda)
        view = buf[off:off + n]
        view.copy_(torch.from_numpy(a))
        return view

    ops.reset_launch_counts()
    got = seg.segmented_sum(at(gids, id_off), at(vals, val_off), g).cpu()
    igot = seg.segmented_int_sum(at(gids, id_off), at(ivals, val_off),
                                 g).cpu()
    counts = ops.launch_counts()
    assert counts["segmented_sum"] == 1 and counts["segmented_int_sum"] == 1
    t_ids = torch.from_numpy(gids)
    np.testing.assert_array_equal(
        igot.numpy(),
        seg.segmented_int_sum_plain(t_ids, torch.from_numpy(ivals), g).numpy())
    want = seg.segmented_sum_plain(t_ids, torch.from_numpy(vals), g).numpy()
    scale = seg.segmented_sum_plain(t_ids, torch.from_numpy(np.abs(vals)),
                                    g).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 1e-4 * scale + 1e-6)


def test_segmented_kernels_reject_wrong_inputs(cuda):
    gids = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        seg.segmented_sum(gids, torch.ones(8, device=cuda), 4)
    with pytest.raises(ValueError):
        seg.segmented_int_sum(gids.int(), torch.ones(8, dtype=torch.int32), 4)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_kernel_on_card(cuda, case):
    data = seeded_columns(5000, seed=11)
    host = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    host = host.filter(torch.from_numpy(np.arange(5000) % 7 != 3))
    want = fused.apply_stages(host, _CASES[case])
    dev = TorchTable({n: a.to(cuda) for n, a in host.columns.items()},
                     host.validity.to(cuda), host.schema)
    ops.reset_launch_counts()
    got, _, _ = fused.fused_morsel_program(dev, _CASES[case])
    assert ops.launch_counts()["fused_morsel_program"] == 1
    got = TorchTable({n: a.cpu() for n, a in got.columns.items()},
                     got.validity.cpu(), got.schema)
    assert_tables_equal(got, want)


def _to(table, device, rows=slice(None)):
    """The rows ``rows`` of ``table`` on ``device``, as views of one copy
    (a one-row offset leaves every column base unaligned)."""
    cols = {k: a.to(device)[rows] for k, a in table.columns.items()}
    return TorchTable(cols, table.validity.to(device)[rows], table.schema)


def _host(table):
    return TorchTable({k: a.cpu() for k, a in table.columns.items()},
                      table.validity.cpu(), table.schema)


# (rows, offset): fewer rows than a thread's four, one tile plus a ragged
# group, and column views at a one-row offset
_RAGGED = [(1, 0), (3, 0), (1027, 0), (5001, 1), (4096, 1), (3, 1)]


@pytest.mark.parametrize("n,offset", _RAGGED)
@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_kernel_on_card_ragged_and_offset(cuda, case, n, offset):
    data = seeded_columns(n + offset + 4, seed=11)
    host = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    host = host.filter(torch.from_numpy(np.arange(host.capacity) % 7 != 3))
    rows = slice(offset, offset + n)
    want = fused.apply_stages(_to(host, "cpu", rows), _CASES[case])
    ops.reset_launch_counts()
    got, _, _ = fused.fused_morsel_program(_to(host, cuda, rows), _CASES[case])
    assert ops.launch_counts()["fused_morsel_program"] == 1
    assert_tables_equal(_host(got), want)


def _wide_case(n_cols: int, n: int):
    """n_cols int32 columns, each projected plus the next behind a filter:
    2 * n_cols registers (48 at 24 columns, the lowering's kMaxRegs)."""
    rng = np.random.default_rng(n_cols)
    data = {f"c{k}": rng.integers(-1000, 1000, n).astype(np.int32)
            for k in range(n_cols)}
    host = TorchTable.from_numpy(data, {k: port_dtypes.INT32 for k in data},
                                 device="cpu")
    stages = [(None, tuple((f"s{k}", col(f"c{k}") + col(f"c{(k + 1) % n_cols}"))
                           for k in range(n_cols)))]
    return host, stages


@pytest.mark.parametrize("n", [5001, 1 << 20])
def test_fused_kernel_on_card_at_max_registers(cuda, n):
    """A program at 48 registers: more than 48 KB of shared memory, one
    load stage."""
    host, stages = _wide_case(24, n)
    program = fused.lower_stages(host, stages)
    assert program.n_regs == fused.LIMITS["kMaxRegs"]
    assert program.plan.smem_bytes() > 48 * 1024 and program.plan.stages == 1
    want = fused.apply_stages(host, stages)
    for rows in (slice(None), slice(1, None)):
        ops.reset_launch_counts()
        got, _, _ = fused.fused_morsel_program(_to(host, cuda, rows), stages)
        assert ops.launch_counts()["fused_morsel_program"] == 1
        assert_tables_equal(_host(got), fused.apply_stages(
            _to(host, "cpu", rows), stages) if rows.start else want)


def test_fused_kernels_refuse_a_bad_plan(cuda):
    """A plan whose operand lies outside its shared memory, or that asks
    for more shared memory than a block has, is refused by the entry
    point (the wrapper raises); nothing falls back to the plain version."""
    import dataclasses
    host = TorchTable.from_numpy(seeded_columns(3000, seed=2), SEEDED_SCHEMA,
                                 device="cpu")
    dev = _to(host, cuda)
    stages = _CASES["arith_f32"]
    program = fused.lower_stages(host, stages)
    plan = program.plan
    head = fused.LIMITS["kPlanHeader"]
    outside = plan.packed.clone()
    outside[head + 2] = plan.comp_bytes     # first ALU's operand a
    too_big = plan.packed.clone()
    too_big[5] = fused.LIMITS["kMaxSmem"]   # stage_bytes
    assert fused.OPS["LOAD32"] not in [r[0] for r in plan.code]
    for bad in (outside, too_big):
        broken = dataclasses.replace(
            program, plan=dataclasses.replace(plan, packed=bad))
        with pytest.raises(RuntimeError, match="CUDA error"):
            fused.fused_morsel_program(dev, stages, program=broken)


@pytest.mark.parametrize("q", [6, 1])
def test_query_on_card_matches_cpu(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog)
    want = Session(catalog, device="cpu").execute(plan)
    ops.reset_launch_counts()
    session = Session(catalog)                 # device=None: the card
    got = session.execute(plan)
    assert ops.launch_counts()["fused_morsel_program"] == 8
    assert session.executor_stats()["kernel_dispatch"] == (
        {"fused": 8} if q == 6 else {"fused": 8, "agg": 15})
    for c, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=2e-3)
        else:
            np.testing.assert_array_equal(got[c], w)


# SQL texts whose fused runs hold BYTESMATCH (Q16's LIKE) and YEAR
_SQL_TEXTS = {
    "q16": None,
    "year_like": "SELECT o_orderkey, EXTRACT(YEAR FROM o_orderdate) AS y "
                 "FROM orders WHERE EXTRACT(YEAR FROM o_orderdate) = 1995 "
                 "AND o_comment LIKE '%special%requests%'",
}


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("name", sorted(_SQL_TEXTS))
def test_sql_text_on_card_matches_cpu(cuda, name, optimize):
    """``Session.sql`` on the card against the CPU at SF 0.01, optimized
    and not: the LIKE and EXTRACT(YEAR) predicates run in the fused
    kernel's BYTESMATCH and YEAR."""
    from repro_torch.core.session import ExecutionOptions
    from repro_torch.tpch import sqltext
    catalog = dbgen.load_catalog(sf=0.01)
    text = _SQL_TEXTS[name] or sqltext.sql_text(16, catalog)
    opts = ExecutionOptions(optimize=optimize)
    want = Session(catalog, device="cpu").sql(text, options=opts).collect()
    ops.reset_launch_counts()
    got = Session(catalog).sql(text, options=opts).collect()
    used = ops.instruction_launches()
    assert used["fused_morsel_program.BYTESMATCH"] > 0
    if name == "year_like":
        assert used["fused_morsel_program.YEAR"] > 0
    assert_results_match(got, want, name)


# ---------------------------------------------------------------------------
# the join kernels (build_table, hash_probe, the fused probe)
# ---------------------------------------------------------------------------

def _homes(keys, t):
    x = keys.astype(np.int64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    return x & (t - 1)


def _build_case(case, n=50_000):
    rng = np.random.default_rng(len(case))
    t = 1 << (2 * n - 1).bit_length()
    valid = np.ones(n, bool)
    if case == "unique":
        keys = rng.permutation(10 * n)[:n].astype(np.int32)
    elif case == "duplicates":
        keys = rng.integers(0, n // 16, n).astype(np.int32)
    elif case == "invalid_and_minus_one":
        # invalid rows and -1 keys, which leave their slots looking empty
        keys = rng.integers(-2, n, n).astype(np.int32)
        valid = rng.random(n) < 0.6
    elif case == "all_ghost_cluster":
        # runs of -1 rows (ghosts) among keys that share their homes
        keys = np.where(rng.random(n) < 0.3, -1,
                        rng.integers(0, n // 4, n)).astype(np.int32)
    elif case == "ghosts_over_a_run":
        # 30 ghosts whose home lies inside the run of a key of 200 rows
        pool = np.arange(1 << 22, dtype=np.int32)
        ghost = int(_homes(np.array([-1], np.int32), t)[0])
        run = pool[_homes(pool, t) == (ghost - 20) % t][0]
        keys = np.concatenate([np.full(200, run), np.full(30, -1),
                               rng.permutation(10 * n)[:n - 230] + (1 << 22)])
        keys = rng.permutation(keys).astype(np.int32)
    elif case == "wrap_through_last_slot":
        pool = np.arange(1 << 22, dtype=np.int32)
        keys = rng.choice(pool[_homes(pool, t) >= t - 64], n).astype(np.int32)
    elif case == "one_home_1000_rows":
        keys = np.concatenate([np.full(1000, 777),
                               rng.permutation(10 * n)[:n - 1000] + 1000])
        keys = rng.permutation(keys).astype(np.int32)
    else:
        # n >= T (the round kernels), valid rows below and above T
        t = 1 << 14
        keys = rng.integers(-1, 1 << 20, n).astype(np.int32)
        valid = rng.random(n) < (0.2 if case == "rounds_below_t" else 0.9)
    return keys, valid, t


_BUILD_CASES = ["unique", "duplicates", "invalid_and_minus_one",
                "all_ghost_cluster", "ghosts_over_a_run",
                "wrap_through_last_slot",
                "one_home_1000_rows", "rounds_below_t", "rounds_above_t"]


@pytest.mark.parametrize("case", _BUILD_CASES)
def test_build_table_on_card_is_bit_identical(cuda, case):
    keys, valid, t = _build_case(case)
    k, v, m = (torch.from_numpy(keys), torch.arange(len(keys), dtype=torch.int32),
               torch.from_numpy(valid))
    want = hp.build_table_plain(k, v, t, -1, m)
    ops.reset_launch_counts()
    got = hp.build_table(k.to(cuda), v.to(cuda), t, -1, m.to(cuda))
    assert ops.launch_counts()["build_table"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("case", ["unique", "duplicates", "invalid_and_minus_one"])
def test_hash_probe_on_card_matches_plain(cuda, case):
    keys, valid, t = _build_case(case)
    tk, tv = hp.build_table_plain(torch.from_numpy(keys),
                                  torch.arange(len(keys), dtype=torch.int32), t,
                                  -1, torch.from_numpy(valid))
    rng = np.random.default_rng(3)
    probe = np.concatenate([rng.choice(keys, 40_000),
                            rng.integers(10 ** 7, 10 ** 8, 20_000),
                            np.full(100, -1)]).astype(np.int32)
    mp = hp.probe_bound(tk)
    want = hp.hash_probe_plain(tk, tv, torch.from_numpy(probe), -1, mp)
    ops.reset_launch_counts()
    got = hp.hash_probe(tk.to(cuda), tv.to(cuda), torch.from_numpy(probe).to(cuda),
                        -1, mp)
    assert ops.launch_counts()["hash_probe"] == 1
    assert hp.probe_bound(tk.to(cuda)) == mp
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("case", ["q3_lineitem", "packed"])
def test_fused_probe_on_card_matches_plain(cuda, case):
    data = seeded_columns(6000, seed=5)
    host = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    rng = np.random.default_rng(8)
    if case == "packed":
        stages = [(col("j") >= lit(-3), (("i", col("i")), ("d", col("d")),
                                         ("x", col("f") * lit(2.0))))]
        keys, pack = ("i", "d"), ((-50, 100), (8000, 2000))
        bcols = [torch.from_numpy(rng.integers(-50, 50, 3000).astype(np.int32)),
                 torch.from_numpy(rng.integers(8000, 10000, 3000).astype(np.int32))]
        from repro_torch.core import relational as rel
        bkey = rel.packed_key(bcols, pack)
    else:   # Q3's lineitem shape: a date filter, then the probe on a raw key
        stages = [(col("d") > date_lit("1995-03-15"), None)]
        keys, pack = ("i",), None
        bkey = torch.from_numpy(rng.permutation(np.arange(-50, 50)).astype(np.int32))
    n = bkey.shape[0]
    t = 1 << (2 * n - 1).bit_length()
    tk, tv = hp.build_table_plain(bkey, torch.arange(n, dtype=torch.int32), t)
    probe = dict(tk=tk, tv=tv, probe_keys=keys, pack=pack, empty_key=-1,
                 max_probes=hp.probe_bound(tk))
    want, wf, wb = fused.fused_morsel_program(host, stages, probe=probe)
    dev = TorchTable({n_: a.to(cuda) for n_, a in host.columns.items()},
                     host.validity.to(cuda), host.schema)
    ops.reset_launch_counts()
    got, gf, gb = fused.fused_morsel_program(
        dev, stages, probe=dict(probe, tk=tk.to(cuda), tv=tv.to(cuda)))
    assert ops.launch_counts()["fused_morsel_probe"] == 1
    assert ops.launch_counts()["fused_morsel_program"] == 0
    assert bool(wf.any())
    assert torch.equal(gf.cpu(), wf) and torch.equal(gb.cpu(), wb)
    got = TorchTable({n_: a.cpu() for n_, a in got.columns.items()},
                     got.validity.cpu(), got.schema)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("n,offset", _RAGGED + [(1 << 20, 0)])
def test_fused_probe_on_card_ragged_and_offset(cuda, n, offset):
    """The probe variant on the sizes and offsets of the program's test:
    every row probed, found and bidx exact."""
    data = seeded_columns(n + offset + 4, seed=6)
    host = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    host = host.filter(torch.from_numpy(np.arange(host.capacity) % 5 != 1))
    keys = np.arange(-50, 50, 3).astype(np.int32)
    keys[0] = -1
    tk, tv = hp.build_table_plain(torch.from_numpy(keys),
                                  torch.arange(len(keys), dtype=torch.int32),
                                  128)
    probe = dict(tk=tk, tv=tv, probe_keys=("i",), pack=None, empty_key=-1,
                 max_probes=hp.probe_bound(tk))
    stages = [(col("f") < lit(5.0), (("i", col("i")),
                                     ("a", col("f") * lit(2.0))))]
    rows = slice(offset, offset + n)
    want, wf, wb = fused.fused_morsel_program(_to(host, "cpu", rows), stages,
                                              probe=probe)
    ops.reset_launch_counts()
    got, gf, gb = fused.fused_morsel_program(
        _to(host, cuda, rows), stages,
        probe=dict(probe, tk=tk.to(cuda), tv=tv.to(cuda)))
    assert ops.launch_counts()["fused_morsel_probe"] == 1
    assert torch.equal(gf.cpu(), wf) and torch.equal(gb.cpu(), wb)
    assert_tables_equal(_host(got), want)


@pytest.mark.parametrize("q", [3, 10])
def test_join_query_on_card_matches_cpu(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog)
    want = Session(catalog, device="cpu").execute(plan)
    ops.reset_launch_counts()
    session = Session(catalog)                 # device=None: the card
    got = session.execute(plan)
    counts = ops.launch_counts()
    # 8 lineitem morsels, and for Q3 2 orders morsels, each one fused launch
    assert counts["fused_morsel_probe"] == (10 if q == 3 else 8)
    assert counts["build_table"] == (2 if q == 3 else 3)
    assert counts["hash_probe"] == (0 if q == 3 else 2)
    assert counts["fused_morsel_program"] == 0
    assert session.executor_stats()["kernel_dispatch"] == (
        {"build": 2, "fused": 10, "agg": 15} if q == 3 else
        {"build": 3, "fused": 8, "agg": 15, "probe": 2})
    assert list(got) == list(want)
    for c, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=2e-3)
        else:
            np.testing.assert_array_equal(got[c], w)


def test_build_above_the_reference_cap_on_card(cuda):
    """A table of 2^19 slots, above the reference's 2^18-slot VMEM cap:
    the port builds and probes it on the card."""
    from repro_torch.core import operators as port_ops
    n = 200_000
    keys = np.random.default_rng(4).permutation(10 * n)[:n].astype(np.int32)
    sch = {"k": port_dtypes.INT32}
    build = TorchTable.from_numpy({"k": keys}, sch, device=cuda)
    probe = TorchTable.from_numpy({"k": keys[::3]}, sch, device=cuda)
    j = port_ops.HashJoin(["k"], ["k"], build_rows=n)
    j.add_build(build)
    ops.reset_launch_counts()
    j.seal_build()
    (out,) = j.add_input(probe)
    assert j._hash_state[1].shape[0] == 1 << 19
    assert ops.launch_counts()["build_table"] == 1
    assert ops.launch_counts()["hash_probe"] == 1
    assert bool(out.validity.all())


# ---------------------------------------------------------------------------
# the all-queries kernels (block_prefix_sum, segmented_minmax,
# hash_probe_multi), each exact against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(1 << 22, 0.3), (3001, 0.5), (5000, 1.0),
                                 (1, 1.0), (0, 0.5)])
def test_block_prefix_sum_on_card(cuda, n, p):
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < p)
    want_pos, want_total = block_prefix_sum_plain(mask)
    ops.reset_launch_counts()
    pos, total = block_prefix_sum(mask.to(cuda))
    # an empty mask launches nothing, and so counts nothing
    assert ops.launch_counts()["block_prefix_sum"] == (1 if n else 0)
    assert torch.equal(pos.cpu(), want_pos)
    assert int(total) == int(want_total) == int(mask.sum())


# the one-pass scan's tiles (16,384 rows, four sections of 4,096): masks
# that end one row short of, on and one row past a tile or section
# boundary, or inside a section's last word; all zeros and all ones; a
# mask whose look-back chain crosses 1024 tiles, more than the card has SMs
_TILE = 16384


@pytest.mark.parametrize("n,p", [(_TILE - 1, 0.5), (_TILE, 0.5),
                                 (_TILE + 1, 0.5), (_TILE // 4 - 1, 0.9),
                                 (_TILE // 4 + 1, 0.9), (_TILE // 4 + 2, 0.9),
                                 (2 * _TILE - 1, 0.7), (2 * _TILE + 1, 0.2),
                                 (3 * _TILE, 0.5), (100_003, 0.0),
                                 (100_003, 1.0), (1 << 24, 0.4)])
def test_block_prefix_sum_tiles_on_card(cuda, n, p):
    mask = torch.from_numpy(np.random.default_rng(n + 7).random(n) < p)
    want_pos, want_total = block_prefix_sum_plain(mask)
    ops.reset_launch_counts()
    pos, total = block_prefix_sum(mask.to(cuda))
    assert ops.launch_counts()["block_prefix_sum"] == 1
    assert torch.equal(pos.cpu(), want_pos)
    assert int(total) == int(want_total) == int(mask.sum())


def test_block_prefix_sum_unaligned_mask_on_card(cuda):
    # a view one byte into its storage: the mask is read byte by byte
    full = torch.from_numpy(np.random.default_rng(5).random(3 * _TILE + 2)
                            < 0.5)
    mask = full.to(cuda)[1:]
    assert mask.data_ptr() % 16 != 0
    want_pos, want_total = block_prefix_sum_plain(full[1:])
    pos, total = block_prefix_sum(mask)
    assert torch.equal(pos.cpu(), want_pos)
    assert int(total) == int(want_total)


def test_block_prefix_sum_repeated_on_card(cuda):
    # the same mask 50 times in a row: a race in the status words would
    # show as one call that differs
    mask = torch.from_numpy(np.random.default_rng(50).random(1 << 22) < 0.3)
    want_pos, want_total = block_prefix_sum_plain(mask)
    dev = mask.to(cuda)
    got = [block_prefix_sum(dev) for _ in range(50)]
    for i, (pos, total) in enumerate(got):
        assert torch.equal(pos.cpu(), want_pos), i
        assert int(total) == int(want_total), i


def test_compact_on_card_matches_cpu(cuda):
    data = seeded_columns(300_000, seed=2)
    host = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    host = host.filter(torch.from_numpy(data["j"] > 0))
    want = host.compact()
    dev = TorchTable({n: a.to(cuda) for n, a in host.columns.items()},
                     host.validity.to(cuda), host.schema).compact()
    got = TorchTable({n: a.cpu() for n, a in dev.columns.items()},
                     dev.validity.cpu(), dev.schema)
    assert_tables_equal(got, want)


def test_compact_of_empty_table_on_card_launches_nothing(cuda):
    host = TorchTable.from_numpy(seeded_columns(10, seed=2), SEEDED_SCHEMA,
                                 device="cpu")
    empty = TorchTable({n: a[:0].to(cuda) for n, a in host.columns.items()},
                       host.validity[:0].to(cuda), host.schema)
    ops.reset_launch_counts()
    out = empty.compact()
    assert ops.launch_counts()["block_prefix_sum"] == 0
    assert out.capacity == 0 and out.validity.is_cuda


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,g", [(1 << 20, 16), (300_000, 20_000), (0, 8)])
def test_segmented_minmax_on_card(cuda, n, g, dtype, kind):
    rng = np.random.default_rng(n + g)
    gids = torch.from_numpy(np.sort(rng.integers(0, g + 1, n)).astype(np.int32))
    if dtype == "float32":
        v = rng.normal(0, 100, n).astype(np.float32)
        v[::97] = np.inf
        v[5::101] = -np.inf
        v[7::1009] = np.nan
    else:
        v = rng.integers(-(1 << 31), (1 << 31) - 1, n,
                         dtype=np.int64).astype(np.int32)
    vals = torch.from_numpy(v)
    want = seg.segmented_minmax_plain(gids, vals, g, kind)
    ops.reset_launch_counts()
    got = seg.segmented_minmax(gids.to(cuda), vals.to(cuda), g, kind).cpu()
    assert ops.launch_counts()["segmented_minmax"] == 1
    # order-free: bit for bit, NaN where the plain version has NaN
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["min", "max"])
def test_segmented_minmax_signed_zeros_on_card(cuda, kind):
    rng = np.random.default_rng(3)
    n, g = 1 << 20, 64
    gids = torch.from_numpy(np.sort(rng.integers(0, g, n)).astype(np.int32))
    vals = torch.from_numpy(np.where(rng.random(n) < 0.5, -0.0, 0.0)
                            .astype(np.float32))
    want = seg.segmented_minmax_plain(gids, vals, g, kind)
    got = seg.segmented_minmax(gids.to(cuda), vals.to(cuda), g, kind).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.signbit(got).all()) == (kind == "min")


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("case", ["unique", "duplicates",
                                  "invalid_and_minus_one"])
def test_hash_probe_multi_on_card_matches_plain(cuda, case, m):
    keys, valid, t = _build_case(case)
    tk, tv = hp.build_table_plain(torch.from_numpy(keys),
                                  torch.arange(len(keys), dtype=torch.int32), t,
                                  -1, torch.from_numpy(valid))
    rng = np.random.default_rng(m)
    probe = torch.from_numpy(np.concatenate([
        rng.choice(keys, 40_000), rng.integers(10 ** 7, 10 ** 8, 20_000),
        np.full(100, -1)]).astype(np.int32))
    mp = hp.probe_bound(tk)
    want = hp.hash_probe_multi_plain(tk, tv, probe, m, -1, mp)
    ops.reset_launch_counts()
    got = hp.hash_probe_multi(tk.to(cuda), tv.to(cuda), probe.to(cuda), m,
                              -1, mp)
    assert ops.launch_counts()["hash_probe_multi"] == 1
    # counts, and every slot: matches in run order, zeros past the count
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# the queries that reach each all-queries kernel, as in the reference's
# pallas runs: expansion joins, compactions, a grouped min (Q15's max has no
# group key, so it is a plain reduction in both engines)
_REACHES = {"hash_probe_multi": (9, 20),
            "block_prefix_sum": (9, 11, 15, 20, 22),
            "segmented_minmax": (2,)}


@pytest.mark.parametrize("q", range(1, 23))
def test_all_queries_on_card_match_cpu(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog)
    cpu = Session(catalog, device="cpu")
    want = cpu.execute(plan)
    ops.reset_launch_counts()
    session = Session(catalog)                 # device=None: the card
    got = session.execute(plan)
    counts = ops.launch_counts()
    for kernel, qs in _REACHES.items():
        assert (counts[kernel] > 0) == (q in qs), kernel
    assert (session.executor_stats()["kernel_dispatch"]
            == cpu.executor_stats()["kernel_dispatch"])
    assert sorted(got) == sorted(want)
    for c, w in want.items():
        assert got[c].shape == w.shape, c
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=2e-3, atol=1e-2)
        else:
            np.testing.assert_array_equal(got[c], w)


@pytest.fixture(scope="module")
def storage_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpch_files"))
    dbgen.write_dataset(root, sf=0.01, chunks=8)
    return root


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("q", [3, 6])
def test_query_from_storage_on_card_matches_cpu(cuda, storage_root, q, skip,
                                                streaming):
    """The column-chunk files read into pinned buffers and copied to the
    card, with zone-map skipping on and off, streaming and synchronous."""
    catalog = dbgen.storage_catalog(storage_root, skip_with_stats=skip)
    plan = queries.build_query(q, catalog)
    cpu = Session(catalog, device="cpu", streaming=streaming)
    want = cpu.execute(plan)
    ops.reset_launch_counts()
    session = Session(catalog, streaming=streaming)   # the card
    got = session.execute(plan)
    counts = ops.launch_counts()
    tables = session.executor_stats()["tables"]
    for t, s in cpu.executor_stats()["tables"].items():
        for k in ("morsels", "bytes_read", "bytes_transferred",
                  "chunks_total", "chunks_skipped"):
            assert tables[t][k] == s[k], (t, k)
    li = tables["lineitem"]
    assert (li["chunks_skipped"] > 0) == skip
    if q == 6 and streaming:
        # one fused launch per surviving chunk (a step of one morsel)
        assert counts["fused_morsel_program"] == li["morsels"]
    assert sorted(got) == sorted(want)
    for c, w in want.items():
        assert got[c].shape == w.shape, c
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=2e-3, atol=1e-2)
        else:
            np.testing.assert_array_equal(got[c], w)


def test_storage_morsels_are_copied_from_their_pinned_buffers(cuda,
                                                              storage_root):
    """A chunk is read straight into pinned memory, and the copy to the
    card starts from that memory: no second host copy."""
    from repro_torch.core import streaming
    src = dbgen.storage_catalog(storage_root).get("lineitem")
    step = next(src._host_morsels(None, 8192, num_workers=2, pin=True))
    for m in step:
        assert set(m.pinned) == set(m.columns) | {None}
        for name, t in m.pinned.items():
            assert t.is_pinned()
            a = m.validity if name is None else m.columns[name]
            assert a.ctypes.data == t.data_ptr()
            dtype = (torch.bool if name is None
                     else m.schema[name].torch_dtype())
            host = streaming._host_tensor(t, dtype, True)
            assert host.data_ptr() == t.data_ptr()
        got = streaming.morsel_to_device(m, cuda).to_numpy()
        for c, a in m.columns.items():
            np.testing.assert_array_equal(got[c], a[m.validity])


@pytest.mark.parametrize("n,p", [(0, 4), (1, 1), (5000, 4), (1 << 20, 16),
                                 (3001, 64), (100_003, 8192),
                                 (100_003, 8193)])
def test_radix_histogram_on_card(cuda, n, p):
    rng = np.random.default_rng(n + p)
    ids = rng.integers(-2, p + 2, n).astype(np.int32)
    ids[:3] = [-1, p, np.iinfo(np.int32).max][:min(n, 3)]
    ops.reset_launch_counts()
    got = radix_histogram(torch.from_numpy(ids).to(cuda), p).cpu()
    assert ops.launch_counts()["radix_histogram"] == (1 if n else 0)
    want = radix_histogram_plain(torch.from_numpy(ids), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_radix_histogram_rejects_wrong_inputs(cuda):
    with pytest.raises(TypeError):
        radix_histogram(torch.zeros(8, dtype=torch.int64, device=cuda), 4)
    with pytest.raises(ValueError):
        radix_histogram(torch.zeros(8, dtype=torch.int32, device=cuda), 0)


@pytest.mark.parametrize("q", range(1, 23))
def test_all_queries_at_four_workers_on_card_match_one_worker(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    one = Session(catalog).execute(queries.build_query(q, catalog))
    ops.reset_launch_counts()
    session = Session(catalog, num_workers=4)  # ICIExchange
    got = session.execute(queries.build_query(q, catalog, num_workers=4))
    counts = ops.launch_counts()
    stats = session.executor_stats()
    # a repartition's fragment label names its keys, a broadcast's does not
    rounds = sum(v["rounds"] for k, v in stats["exchanges"].items()
                 if "(" in k)
    assert counts["radix_histogram"] == rounds
    assert stats["kernel_dispatch"].get("partition", 0) == rounds
    assert all(v["host_staged_bytes"] == 0
               for v in stats["exchanges"].values())
    assert sorted(got) == sorted(one)
    for c, w in one.items():
        assert got[c].dtype == w.dtype, c
    assert_results_match(got, one, q)


@pytest.mark.parametrize("q", [1, 3, 5, 6, 13, 22])
def test_host_exchange_on_card_matches_ici(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog, num_workers=2)
    ici = Session(catalog, num_workers=2).execute(plan)
    ops.reset_launch_counts()
    host = Session(catalog, num_workers=2, exchange=HostExchange())
    got = host.execute(plan)
    assert ops.launch_counts()["radix_histogram"] == 0
    exchanges = host.executor_stats()["exchanges"]
    assert sum(v["host_staged_bytes"] for v in exchanges.values()) > 0
    assert_results_match(got, ici, q)


def _exchange_rows(stats):
    return {k: (v["rounds"], v["rows_moved"], v["bytes_moved"],
                v["host_staged_bytes"]) for k, v in stats["exchanges"].items()}


@pytest.mark.parametrize("q", [3, 5, 9, 13, 21])
def test_queries_on_a_one_card_mesh_match_off_mesh(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog, num_workers=4)
    off = Session(catalog, num_workers=4)
    want = off.execute(plan)
    on = Session(catalog, num_workers=4,
                 mesh=EngineMesh([torch.device("cuda", 0)]))
    got = on.execute(plan)
    stats = on.executor_stats()
    assert stats["worker_devices"] == ["cuda:0"] * 4
    assert _exchange_rows(stats) == _exchange_rows(off.executor_stats())
    assert all(v[3] == 0 for v in _exchange_rows(stats).values())
    assert_results_match(got, want, q)


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


def test_launch_runs_under_its_tensors_device(cuda):
    _cards(2)
    gen = torch.Generator().manual_seed(3)
    keys = [[torch.randint(-99, 99, (5000,), generator=gen,
                           dtype=torch.int32)] for _ in range(2)]
    valid = [torch.rand(5000, generator=gen) < 0.7 for _ in range(2)]
    with torch.cuda.device(0):
        pids, counts = partition_histogram(
            [[k.to("cuda:1") for k in ks] for ks in keys],
            [v.to("cuda:1") for v in valid], 2)
        gids = torch.arange(5000, dtype=torch.int32, device="cuda:1") % 7
        sums = seg.segmented_int_sum(gids, gids, 7)
    want_pids, want_counts = partition_histogram_plain(keys, valid, 2)
    assert pids.device == torch.device("cuda", 1)
    assert torch.equal(pids.cpu(), want_pids)
    assert torch.equal(counts.cpu(), want_counts)
    assert torch.equal(sums.cpu(), seg.segmented_int_sum_plain(
        gids.cpu(), gids.cpu(), 7))


def test_bare_cuda_means_one_device_for_mesh_and_session(cuda):
    _cards(2)
    catalog = dbgen.load_catalog(sf=0.002)
    with torch.cuda.device(1):
        session = Session(catalog, device="cuda", num_workers=4,
                          mesh=EngineMesh(["cuda"]))
        assert session.device == torch.device("cuda", 1)
        session.execute(queries.build_query(6, catalog, num_workers=4))
    assert session.executor_stats()["worker_devices"] == ["cuda:1"] * 4


@pytest.mark.parametrize("q", [3, 5, 13])
def test_queries_on_a_mesh_of_cards_match_off_mesh(cuda, q):
    _cards(2)
    from repro_torch.core.driver import Driver
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog, num_workers=4)
    mesh = EngineMesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    on = Session(catalog, num_workers=4, mesh=mesh)
    got = on.execute(plan)
    assert on.last_driver.ctx.exchange.peer_bytes > 0
    want = Session(catalog, num_workers=4).execute(plan)
    assert_results_match(got, want, q)
    tables = Driver(on.context()).execute(plan)
    assert [t.device for t in tables] == mesh.worker_devices(4)


# ---------------------------------------------------------------------------
# inter-query batching: fused_batch_program and the serving path
# ---------------------------------------------------------------------------

def _batch_case(n: int, lanes: int):
    """A three-stage batch program over ``seeded_columns`` (parameters of
    float32, int32, date32 and bool), every fifth row dead, with distinct
    parameters per lane: ``(cpu table, stages, cpu params)``."""
    from repro_torch.core import batch
    rows = max(n, 4)
    data = {k: v[:n] for k, v in seeded_columns(rows, seed=13).items()}
    cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        SEEDED_SCHEMA[k].torch_dtype()) for k, v in data.items()}
    host = TorchTable(cols, torch.from_numpy(np.arange(n) % 5 != 2),
                      dict(SEEDED_SCHEMA))
    raw = [(col("f") < lit(5.0), (("a", col("f") * lit(2.0)),
                                  ("i", col("i")), ("d", col("d")),
                                  ("b", col("b")))),
           (col("i") > lit(-20), None),
           ((col("d") >= date_lit("1995-01-01")) | (col("b") == lit(True)),
            (("s", col("a") + col("i")), ("i", col("i")),
             ("t", col("a") >= lit(1.0))))]
    dtypes, values, stages = [], [], []
    for f, projections in raw:
        stages.append((batch._parameterize(f, dtypes, values), projections))
    params = []
    for d, v in zip(dtypes, values):
        if d.name == "bool":
            lane_vals = [bool(v) != bool(b % 2) for b in range(lanes)]
        elif d.name == "float32":
            lane_vals = [float(v) + 0.25 * b for b in range(lanes)]
        else:
            lane_vals = [int(v) + 7 * b for b in range(lanes)]
        params.append(torch.tensor(lane_vals, dtype=d.torch_dtype()))
    return host, stages, tuple(params)


@pytest.mark.parametrize("n", [0, 1000, 1 << 20])
@pytest.mark.parametrize("lanes", [1, 2, 32, 64, 65, 128])
def test_fused_batch_kernel_on_card(cuda, lanes, n):
    host, stages, params = _batch_case(n, lanes)
    want, want_masks = fused.apply_batched_stages(host, stages, params, lanes)
    dev = TorchTable({k: a.to(cuda) for k, a in host.columns.items()},
                     host.validity.to(cuda), host.schema)
    ops.reset_launch_counts()
    got, masks = fused.fused_batch_program(
        dev, stages, tuple(p.to(cuda) for p in params), lanes)
    torch.cuda.synchronize()
    # one launch per run of the kernel's 64 lanes
    assert ops.launch_counts()["fused_batch_program"] == (
        -(-lanes // 64) if n else 0)
    assert got.validity is dev.validity
    np.testing.assert_array_equal(masks.cpu().numpy(), want_masks.numpy())
    got = TorchTable({k: a.cpu() for k, a in got.columns.items()},
                     got.validity.cpu(), got.schema)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("n,offset", [(3, 0), (4097, 0), (4097, 1),
                                      (999_999, 1)])
@pytest.mark.parametrize("lanes", [64, 65])
def test_fused_batch_kernel_on_card_ragged_and_offset(cuda, lanes, n, offset):
    host, stages, params = _batch_case(n + offset, lanes)
    rows = slice(offset, offset + n)
    want, want_masks = fused.apply_batched_stages(_to(host, "cpu", rows),
                                                  stages, params, lanes)
    dev = _to(host, cuda, rows)
    ops.reset_launch_counts()
    got, masks = fused.fused_batch_program(
        dev, stages, tuple(p.to(cuda) for p in params), lanes)
    assert ops.launch_counts()["fused_batch_program"] == -(-lanes // 64)
    np.testing.assert_array_equal(masks.cpu().numpy(), want_masks.numpy())
    assert_tables_equal(_host(got), want)


def test_fused_batch_kernel_on_card_at_max_registers(cuda):
    """The 48-register program as a batch program (its filter a lane loop
    over a parameter), 40 lanes, at a one-row offset."""
    from repro_torch.core import batch
    host, stages = _wide_case(23, 5001)
    dtypes, values = [], []
    pred = batch._parameterize(col("c0") < lit(0), dtypes, values)
    stages = [(pred, stages[0][1])]
    params = (torch.arange(-1000, 1000, 50, dtype=torch.int32),)
    lanes = params[0].shape[0]
    program = fused.lower_stages(host, stages, batch=True)
    assert program.plan.smem_bytes(lanes) > 48 * 1024
    rows = slice(1, None)
    want, want_masks = fused.apply_batched_stages(_to(host, "cpu", rows),
                                                  stages, params, lanes)
    got, masks = fused.fused_batch_program(
        _to(host, cuda, rows), stages, tuple(p.to(cuda) for p in params),
        lanes)
    np.testing.assert_array_equal(masks.cpu().numpy(), want_masks.numpy())
    assert_tables_equal(_host(got), want)


def test_fused_batch_kernel_rejects_wrong_inputs(cuda):
    host, stages, params = _batch_case(100, 2)
    dev = TorchTable({k: a.to(cuda) for k, a in host.columns.items()},
                     host.validity.to(cuda), host.schema)
    on_card = tuple(p.to(cuda) for p in params)
    with pytest.raises(ValueError):     # no lane
        fused.fused_batch_program(dev, stages, tuple(
            p[:0] for p in on_card), 0)
    with pytest.raises(ValueError):     # parameters on the host
        fused.fused_batch_program(dev, stages, params, 2)


@pytest.mark.parametrize("kind", ["count", "sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_stacked_segment_agg_on_card(cuda, kind, dtype):
    """The stacked ids of ``_stacked_segment_agg`` as the batch gives them:
    unsorted (member-dead rows break runs), sentinel gids between runs, a
    member with no live row; the CUDA kernels against their plain versions."""
    from repro_torch.core import batch
    rng = np.random.default_rng(21)
    n, lanes, groups = 300_000, 32, 16
    gids = np.sort(rng.integers(0, groups + 1, n)).astype(np.int32)
    member = (rng.random((lanes, n)) < 0.5) & (gids < groups)[None, :]
    member[7] = False
    vals = (rng.normal(0, 100, n).astype(np.float32) if dtype == "float32"
            else rng.integers(-1000, 1000, n).astype(np.int32))
    args = [torch.from_numpy(vals), torch.from_numpy(member),
            torch.from_numpy(gids)]
    want = batch._stacked_segment_agg(*args, groups, lanes, kind)
    got = batch._stacked_segment_agg(*[a.to(cuda) for a in args], groups,
                                     lanes, kind).cpu()
    if kind == "sum" and dtype == "float32":
        scale = batch._stacked_segment_agg(
            torch.from_numpy(np.abs(vals)), *args[1:], groups, lanes, kind)
        assert bool(((got - want).abs() <= 1e-4 * scale + 1e-3).all())
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_serving_workload_on_card_matches_cpu(cuda):
    """Twelve distinct-literal small queries of the three serving shapes
    through the card's batching scheduler, each equal to its CPU run."""
    import threading

    from repro_torch import SchedulerConfig
    from repro_torch.core.builder import QueryBuilder

    catalog = dbgen.load_catalog(sf=0.01)
    keys = catalog.get("orders").data["o_orderkey"]
    builders = []
    for i in range(12):
        if i % 3 == 0:
            builders.append(QueryBuilder.scan(catalog, "orders")
                            .filter(col("o_orderkey") == int(keys[i * 31]))
                            .project("o_orderkey", "o_totalprice"))
        elif i % 3 == 1:
            builders.append(QueryBuilder.scan(catalog, "lineitem")
                            .filter(col("l_quantity") < float(2 + i))
                            .project(rev=col("l_extendedprice")
                                     * col("l_discount"))
                            .agg(total=("sum", "rev"), n=("count", None)))
        else:
            builders.append(QueryBuilder.scan(catalog, "lineitem")
                            .filter(col("l_quantity") < float(3 + i))
                            .group_by("l_returnflag")
                            .agg(total=("sum", "l_extendedprice"),
                                 n=("count", None)))
    cpu = Session(catalog, device="cpu")
    want = [cpu.execute(b.optimized()) for b in builders]
    session = Session(catalog)
    session.scheduler_config = SchedulerConfig(
        batching=True, max_batch=32, batch_window_ms=100.0,
        cache_results=False)
    ops.reset_launch_counts()
    handles = [None] * len(builders)

    def client(c):
        for i in range(c, len(builders), 4):
            handles[i] = session.submit(builders[i])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    got = session.gather(*handles)
    stats = session.scheduler().stats()
    session.scheduler().close()
    assert stats["batches"] >= 1 and stats["batch_fallbacks"] == 0
    assert ops.launch_counts()["fused_batch_program"] >= 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        assert_results_match(g, w, i)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# float32 within 2e-5 (3xTF32; one TF32 product misses it), bfloat16 and
# float16 within 2e-2 (P rounds to the input dtype before P V, as the
# oracle's probs do); every
# dtype also within SCALED_ERROR_TOL of scaled_error, which scales with each
# row's own size where the fixed limit does not
_ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
_ATTN_CASES = (
    # the CPU tests' grid (the reference's own)
    [(1, 1, 128, 64, c) for c in (True, False)]
    + [(2, 2, 256, 64, c) for c in (True, False)]
    + [(1, 2, 256, 128, c) for c in (True, False)]
    # the repository's head dims, and the kernel's widest tile
    + [(1, 2, 256, d, True) for d in (64, 128, 160, 192, 256)]
    # rows and head dims that fill no tile: S = 96, 1; D = 40, 1
    + [(1, 2, 96, 64, True), (1, 3, 1, 64, False), (1, 2, 256, 40, True),
       (1, 2, 256, 1, False), (8, 12, 256, 64, True)])


@pytest.fixture
def no_tf32(cuda):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("b,h,s,d,causal", _ATTN_CASES)
def test_flash_attention_on_card(no_tf32, b, h, s, d, causal, dtype):
    from repro_torch.kernels.flash_attention import (
        SCALED_ERROR_TOL, flash_attention, flash_attention_plain,
        scaled_error)
    rng = np.random.default_rng(b * 1000 + s + d)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, h, s, d)).astype(
        np.float32)).to(no_tf32, getattr(torch, dtype)) for _ in range(3))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, block_q=min(s, 32),
                          block_k=min(s, 32))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == q.dtype
    want = flash_attention_plain(q, k, v, causal)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _ATTN_TOL[dtype], err
    scaled = scaled_error(got, want, v, causal)
    assert scaled <= SCALED_ERROR_TOL, scaled


def _device_kernels(fn):
    """Names of the kernels one call of ``fn`` ran on the card, from
    ``torch.profiler``, with the card idle for 20 ms at each end of the
    window (the profiler drops a device event that it places outside its
    window); a profile that comes back without device events is taken
    again, at most five times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        names = {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if names:
            return names
    return names


# (shape [B, H, S, D], causal, offset of the bases in elements, kernels):
# the split over K (B*H * S / 128 CTAs below the card's 132 SMs), with
# rows whose split lies past their diagonal (64-key tiles at D > 128); the
# widest tile without a split; and a base one element off 16 bytes, which
# TMA cannot address, on the mma.sync kernel
_ATTN_PATHS = {
    "split_d192_dead_rows": ((1, 2, 1024, 192), True, 0,
                             {"attn_wgmma_kernel", "attn_combine_kernel"}),
    "split_d160_full": ((1, 2, 1024, 160), False, 0,
                        {"attn_wgmma_kernel", "attn_combine_kernel"}),
    "split_d256": ((1, 1, 1024, 256), True, 0,
                   {"attn_wgmma_kernel", "attn_combine_kernel"}),
    "split_d64": ((1, 1, 1024, 64), True, 0,
                  {"attn_wgmma_kernel", "attn_combine_kernel"}),
    "d256": ((2, 12, 1024, 256), True, 0, {"attn_wgmma_kernel"}),
    "unaligned": ((1, 2, 256, 64), True, 1, {"attn_mma_kernel"}),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", sorted(_ATTN_PATHS))
def test_flash_attention_paths_on_card(no_tf32, case, dtype):
    from repro_torch.kernels.flash_attention import (
        SCALED_ERROR_TOL, flash_attention, flash_attention_plain,
        scaled_error)
    shape, causal, offset, kernels = _ATTN_PATHS[case]
    n = int(np.prod(shape))
    rng = np.random.default_rng(sum(shape) + offset)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, n + offset).astype(
        np.float32)).to(no_tf32, getattr(torch, dtype))[offset:].view(shape)
        for _ in range(3))
    assert (q.data_ptr() % 16 != 0) == (offset != 0)
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    ran = _device_kernels(lambda: flash_attention(q, k, v, causal=causal))
    assert {want for want in kernels if any(want in r for r in ran)} == \
        kernels, ran
    assert not any(x in r for r in ran for x in (
        "attn_wgmma_kernel", "attn_combine_kernel", "attn_mma_kernel",
        "attn_tf32x3_kernel") if x not in kernels), ran
    want = flash_attention_plain(q, k, v, causal)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _ATTN_TOL[dtype], err
    scaled = scaled_error(got, want, v, causal)
    assert scaled <= SCALED_ERROR_TOL, scaled


# float32 (shape, causal, offset of the bases in elements, kernels): the
# split over K (B*H * S / 64 CTAs below the card's SMs) with rows whose
# split lies past their diagonal; no split at the widest tile; 4-byte
# copies where a base is off 16 bytes or D % 4 != 0
_F32_PATHS = {
    "split_d192_dead_rows": ((1, 2, 1024, 192), True, 0,
                             {"attn_tf32x3_kernel", "attn_combine_kernel"}),
    "split_d160_full": ((1, 2, 1024, 160), False, 0,
                        {"attn_tf32x3_kernel", "attn_combine_kernel"}),
    "split_d1": ((1, 1, 512, 1), True, 0,
                 {"attn_tf32x3_kernel", "attn_combine_kernel"}),
    "d256": ((2, 12, 1024, 256), True, 0, {"attn_tf32x3_kernel"}),
    "d128_full": ((1, 12, 2048, 128), False, 0, {"attn_tf32x3_kernel"}),
    "unaligned": ((2, 12, 512, 64), True, 1, {"attn_tf32x3_kernel"}),
    "d40": ((3, 12, 512, 40), True, 0, {"attn_tf32x3_kernel"}),
}


@pytest.mark.parametrize("case", sorted(_F32_PATHS))
def test_flash_attention_f32_paths_on_card(no_tf32, case):
    from repro_torch.kernels.flash_attention import (
        SCALED_ERROR_TOL, flash_attention, flash_attention_plain,
        scaled_error)
    shape, causal, offset, kernels = _F32_PATHS[case]
    n = int(np.prod(shape))
    rng = np.random.default_rng(sum(shape) + offset)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, n + offset).astype(
        np.float32)).to(no_tf32)[offset:].view(shape) for _ in range(3))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    ran = _device_kernels(lambda: flash_attention(q, k, v, causal=causal))
    assert {want for want in kernels if any(want in r for r in ran)} == \
        kernels, ran
    assert not any(x in r for r in ran for x in (
        "attn_wgmma_kernel", "attn_combine_kernel", "attn_mma_kernel",
        "attn_tf32x3_kernel") if x not in kernels), ran
    want = flash_attention_plain(q, k, v, causal)
    err = float((got - want).abs().max())
    assert err <= _ATTN_TOL["float32"], err
    assert scaled_error(got, want, v, causal) <= SCALED_ERROR_TOL


def test_flash_attention_rejects_wrong_inputs_on_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros((1, 1, 192, 64), device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError):     # S does not divide by the blocks
        flash_attention(q, q, q, block_k=128)
    wide = torch.zeros((1, 1, 128, 257), device=cuda)
    with pytest.raises(ValueError):     # D above the kernel's 256
        flash_attention(wide, wide, wide)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):     # k on the host
        flash_attention(q, q.cpu(), q)
    assert ops.launch_counts()["flash_attention"] == 0


def _build_events(fn):
    """(kernel name -> launches, every device event name) of one call of
    ``fn``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = prof.key_averages()
        kernels = {e.key: e.count for e in events
                   if e.device_type == DeviceType.CUDA
                   and "build_" in e.key and "_kernel" in e.key}
        if kernels:
            return kernels, {e.key for e in events}
    return {}, set()


def test_build_table_launches_depend_on_shape_only(cuda):
    """Below table_size rows the build's launches are fixed by the shape:
    duplicate keys (long clusters) launch what unique keys launch, nothing
    is copied back, and a call queued behind a 0.1 s spin on the card
    returns at once (it does not synchronise). Last in the file: a process
    whose first profile comes before the threads and streams of the
    serving and multi-worker tests loses the device events of later
    profiles."""
    seen = []
    for case in ("unique", "duplicates"):
        keys, valid, t = _build_case(case)
        k, v = (torch.from_numpy(keys).to(cuda),
                torch.arange(len(keys), dtype=torch.int32, device=cuda))
        kernels, names = _build_events(lambda: hp.build_table(k, v, t, -1))
        assert kernels, case
        assert not any("DtoH" in n for n in names), names
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        hp.build_table(k, v, t, -1)
        waited = time.perf_counter() - t0
        torch.cuda.synchronize()
        assert waited < 0.02, waited
        seen.append(kernels)
    assert seen[0] == seen[1]
    assert sum(seen[0].values()) == 3 + -(-17 // 8)   # T = 2^17


# ---------------------------------------------------------------------------
# out of core: the grace join's histogram and the grace join on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,n,p", [(1, 1_500_000, 64), (1, 100_003, 2),
                                   (4, 262_147, 64), (1, 1, 2)])
def test_grace_histogram_on_card(cuda, w, n, p):
    """The standalone histogram at grace shapes (W * P bins, the dead rows
    in bin W * P, counts of ids that are no multiple of the block): exact
    against its plain version, one launch."""
    rng = np.random.default_rng(n + p)
    ids = torch.from_numpy(rng.integers(0, w * p + 1, w * n).astype(np.int32))
    ops.reset_launch_counts()
    got = radix_histogram(ids.to(cuda), w * p).cpu()
    assert ops.launch_counts()["radix_histogram"] == 1
    assert torch.equal(got, radix_histogram_plain(ids, w * p))


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("join_type", ["inner", "left_semi", "left_anti",
                                       "left_outer"])
def test_grace_hash_join_on_card_matches_cpu(cuda, join_type, workers):
    """``GraceHashJoin`` on the card against the same join on the CPU: the
    same rows, the same spill counters, one histogram launch a
    ``_grace_pids`` call, and every output on the card."""
    from repro_torch.core import operators as port_ops
    from repro_torch.core.spill import SpillManager

    rng = np.random.default_rng(7)
    schema = {"k": port_dtypes.INT32, "b": port_dtypes.INT32}
    keys = rng.permutation(1 << 20)[:5000].astype(np.int32)

    def side(n, cap, dev):
        data = {"k": keys[rng.integers(0, len(keys), n)],
                "b": rng.integers(-9, 9, n).astype(np.int32)}
        valid = np.pad(rng.random(n) < 0.9, (0, cap - n))
        return data, valid

    build = [side(6000, 8192, None) for _ in range(workers)]
    probes = [[side(3000, 4096, None) for _ in range(workers)]
              for _ in range(2)]

    def table(d, v, dev):
        return TorchTable.from_numpy(d, schema, capacity=len(v),
                                     device=dev).filter(
            torch.from_numpy(v).to(dev))

    def run(dev):
        mgr = SpillManager(0, device=dev)
        payload = () if join_type in ("left_semi", "left_anti") else ("b",)
        op = port_ops.GraceHashJoin(("k",), ("k",), payload, join_type, 4,
                                    build_rows=6000 * workers, spill=mgr,
                                    reservation=40_000 * workers)
        op.open()
        op.add_build([table(d, v, dev) for d, v in build])
        op.seal_build()
        outs = []
        for step in probes:
            outs += op.add_input([table(d, v, dev) for d, v in step])
        outs += op.finish()
        rows = []
        for step in outs:
            for t in step:
                assert t.device.type == torch.device(dev).type
                live = t.validity.cpu().numpy()
                rows += list(zip(*(t.columns[c].cpu().numpy()[live].tolist()
                                   for c in sorted(t.columns))))
        return sorted(rows), mgr.stats.summary()

    ops.reset_launch_counts()
    got, got_stats = run(cuda)
    assert ops.launch_counts()["radix_histogram"] == 3
    want, want_stats = run("cpu")
    assert got == want and got_stats == want_stats
    assert got_stats["host"]["spills"] > 0


@pytest.mark.parametrize("q", [3, 18])
def test_feedback_cold_warm_on_card_matches_cpu(cuda, q):
    """Adaptive execution on the card at SF 0.01: Q3 and Q18 cold then
    warm give the CPU's answers, the same warm plans and the same store
    entries (the counts and build multiplicities were kept on the card
    until one read-back per query)."""
    from repro_torch.core import plan as port_plan
    catalog = dbgen.load_catalog(sf=0.01)
    raw = queries.build_query(q, catalog, optimized=False)

    def run(device):
        session = Session(catalog, device=device, feedback=True)
        cold_plan = session.optimize(raw)
        cold = session.execute(cold_plan)
        warm_plan = session.optimize(raw)
        warm = session.execute(warm_plan)
        entries = {k: (e.rows, e.estimated, e.max_matches, e.skip_fraction)
                   for k, e in session.feedback_store()._entries.items()}
        return cold, warm, port_plan.fingerprint(warm_plan), entries

    got, want = run(None), run("cpu")
    assert got[2] == want[2]
    assert got[3] == want[3]
    for g, w in zip(got[:2], want[:2]):
        assert_results_match(g, w, q)


# ---------------------------------------------------------------------------
# serving, out of core and adaptive execution on a mesh of cards
# ---------------------------------------------------------------------------

_MESH_BUDGET = 64 * 1024


def _mesh_of(*indices):
    return EngineMesh([torch.device("cuda", i) for i in indices])


def _cpu_mesh_session(catalog, w, **kw):
    return Session(catalog, device="cpu", num_workers=w,
                   mesh=EngineMesh([torch.device("cpu")]), **kw)


def test_serving_on_a_one_card_mesh_matches_off_mesh(cuda):
    """``submit``/``gather`` at W = 4 on ``EngineMesh([cuda:0])`` equal
    the same plans' ``execute`` off the mesh, every worker on the card;
    batched W = 1 serving on the mesh equals solo execution."""
    from repro_torch import SchedulerConfig
    from repro_torch.core.builder import QueryBuilder
    from repro_torch.core.expr import col
    catalog = dbgen.load_catalog(sf=0.01)
    plans = {q: queries.build_query(q, catalog, num_workers=4)
             for q in (3, 5, 18)}
    off = Session(catalog, num_workers=4)
    on = Session(catalog, num_workers=4, mesh=_mesh_of(0))
    try:
        handles = [on.submit(p) for p in plans.values()]
        got = on.gather(*handles)
    finally:
        on.scheduler().close()
    for (q, plan), g, h in zip(plans.items(), got, handles):
        assert_results_match(g, off.execute(plan), q)
        assert h.executor_stats["worker_devices"] == ["cuda:0"] * 4
    builders = [QueryBuilder.scan(catalog, "lineitem")
                .filter(col("l_quantity") < float(2 + i))
                .agg(n=("count", None)) for i in range(16)]
    solo = Session(catalog)
    one = Session(catalog, mesh=_mesh_of(0))
    one.scheduler_config = SchedulerConfig(batching=True,
                                           batch_window_ms=100.0,
                                           cache_results=False)
    try:
        handles = [one.submit(b) for b in builders]
        got = one.gather(*handles)
        stats = one.scheduler().stats()
    finally:
        one.scheduler().close()
    assert stats["batches"] >= 1 and stats["batch_fallbacks"] == 0
    for b, g in zip(builders, got):
        assert_results_match(g, solo.execute(b.optimized()), 1)


@pytest.mark.parametrize("q", [3, 5, 18])
def test_spill_on_a_one_card_mesh_matches_cpu(cuda, q):
    """Under a 64 KiB budget at W = 4 on ``EngineMesh([cuda:0])``: the
    CPU mesh's answer and spill counters."""
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog, num_workers=4)
    on = Session(catalog, num_workers=4, mesh=_mesh_of(0),
                 device_budget=_MESH_BUDGET)
    cpu = _cpu_mesh_session(catalog, 4, device_budget=_MESH_BUDGET)
    assert_results_match(on.execute(plan), cpu.execute(plan), q)
    got = on.executor_stats()["spill"]
    assert got == cpu.executor_stats()["spill"] and got["spilled_bytes"]


@pytest.mark.parametrize("q", [3, 18])
def test_feedback_on_a_one_card_mesh_matches_cpu(cuda, q):
    """Cold then warm at W = 4 on ``EngineMesh([cuda:0])``: the CPU
    mesh's answers, warm plans and store entries."""
    from repro_torch.core import plan as port_plan
    catalog = dbgen.load_catalog(sf=0.01)
    raw = queries.build_query(q, catalog, optimized=False)

    def run(session):
        session.execute(session.optimize(raw))
        warm_plan = session.optimize(raw)
        warm = session.execute(warm_plan)
        entries = {k: (e.rows, e.estimated, e.max_matches, e.skip_fraction)
                   for k, e in session.feedback_store()._entries.items()}
        return warm, port_plan.fingerprint(warm_plan), entries

    got = run(Session(catalog, num_workers=4, mesh=_mesh_of(0),
                      feedback=True))
    want = run(_cpu_mesh_session(catalog, 4, feedback=True))
    assert got[1:] == want[1:]
    assert_results_match(got[0], want[0], q)


@pytest.mark.parametrize("q", [3, 5, 18])
def test_spill_and_feedback_on_two_cards(cuda, q, monkeypatch):
    """W = 4 on ``EngineMesh([cuda:0, cuda:1])`` under a 64 KiB budget:
    every restored partition back on the card it left, the one-card
    mesh's answer and spill counters; cold then warm, the one-card mesh's
    store."""
    _cards(2)
    from repro_torch.core.spill import SpillManager
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.build_query(q, catalog, num_workers=4)
    places = []
    place = SpillManager._place

    def kept(self, part, held):
        out = place(self, part, held)
        places.append((list(part.devices), [t.device for t in out]))
        return out

    monkeypatch.setattr(SpillManager, "_place", kept)
    two = Session(catalog, num_workers=4, mesh=_mesh_of(0, 1),
                  device_budget=_MESH_BUDGET)
    one = Session(catalog, num_workers=4, mesh=_mesh_of(0),
                  device_budget=_MESH_BUDGET)
    got = two.execute(plan)
    assert places and all(a == b for a, b in places)
    assert {d for a, _ in places for d in a} == {torch.device("cuda", 0),
                                                 torch.device("cuda", 1)}
    assert_results_match(got, one.execute(plan), q)
    assert two.executor_stats()["spill"] == one.executor_stats()["spill"]
    raw = queries.build_query(q, catalog, optimized=False)
    stores = []
    for mesh in (_mesh_of(0, 1), _mesh_of(0)):
        session = Session(catalog, num_workers=4, mesh=mesh, feedback=True)
        session.execute(session.optimize(raw))
        session.execute(session.optimize(raw))
        stores.append({k: (e.rows, e.max_matches)
                       for k, e in session.feedback_store()._entries.items()})
    assert stores[0] == stores[1]


def test_grace_histogram_launches_once_a_card(cuda):
    """``_grace_pids`` over a step of four workers on two cards: one
    standalone histogram launch a card, on that card, and the counts and
    pids of the same rows on one card."""
    _cards(2)
    from repro_torch.core import operators as port_ops
    rng = np.random.default_rng(11)
    schema = {"k": port_dtypes.INT32}
    keys = [{"k": rng.integers(-999, 999, 70_001).astype(np.int32)}
            for _ in range(4)]
    one = [TorchTable.from_numpy(k, schema, device="cuda:0") for k in keys]
    two = [TorchTable.from_numpy(k, schema, device=f"cuda:{w // 2}")
           for w, k in enumerate(keys)]
    want_pids, want = port_ops._grace_pids(one, ("k",), 16)
    ops.reset_launch_counts()
    pids, counts = port_ops._grace_pids(two, ("k",), 16)
    assert ops.launch_counts()["radix_histogram"] == 2
    assert torch.equal(counts.cpu(), want.cpu())
    for w, (a, b) in enumerate(zip(pids, want_pids)):
        assert a.device == two[w].device and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("s", [64, 200])
def test_lm_serving_on_card_matches_cpu(cuda, s):
    """qwen2-1.5B's SMOKE config: one set of weights made on the CPU and
    copied to the card; prefill (through the attention kernel, once a
    layer; S 200 a ragged S for it) and 4 greedy decode steps fed the CPU's
    tokens, logits within rtol = atol = 2e-2 of the CPU's."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2_1_5b", smoke=True)
    cpu = build_model(cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    assert build_model(cfg).embed.is_cuda      # no device: the card
    tok = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab, (2, s), dtype=np.int32))
    want, wc = cpu.prefill({"tokens": tok}, s + 4)
    ops.reset_launch_counts()
    got, gc = gpu.prefill({"tokens": tok.to(cuda)}, s + 4)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    for t in range(5):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=2e-2, atol=2e-2)
        if t == 4:
            break
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want, wc = cpu.decode_step(nxt, wc, s + t)
        got, gc = gpu.decode_step(nxt.to(cuda), gc, s + t)


def _mid_training_state(model, seed):
    """The model's weights and a seeded AdamW state at step 150 (past
    warmup): m ~ N(0, 1e-3), v uniform in [0.5e-6, 1.5e-6]."""
    from repro_torch.train import train_state_init
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState
    params = train_state_init(model).params
    gen = torch.Generator().manual_seed(seed)
    m = {k: torch.randn(p.shape, generator=gen) * 1e-3
         for k, p in params.items()}
    v = {k: (torch.rand(p.shape, generator=gen) + 0.5) * 1e-6
         for k, p in params.items()}
    return TrainState(params, AdamWState(torch.tensor(150, dtype=torch.int32),
                                         m, v))


def _on(state, device):
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    def move(tree):
        return {k: x.to(device) for k, x in tree.items()}
    return TrainState(move(state.params), AdamWState(
        state.opt.step.to(device), move(state.opt.m), move(state.opt.v)))


def test_train_step_on_card_matches_cpu(cuda):
    """qwen2-1.5B's SMOKE config, one set of weights and one mid-training
    state made on the CPU and copied to the card, one step of 2
    microbatches (B 4, S 32, base lr 1e-2): the loss within 1e-3, the
    grad norm within 5e-3, m and v within 5e-2 of each leaf's largest
    |value| and each parameter within a bfloat16 ulp plus 0.3 lr of the
    CPU's (bfloat16 gradients round differently on the two devices); the
    card's step after a warm-up one makes no host sync. Then ``adamw_update`` alone on float32
    tensors within 1e-6 relative."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step, optimizer
    cfg = get_config("qwen2_1_5b", smoke=True)
    cpu = build_model(cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    state = _mid_training_state(cpu, 3)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 33), dtype=np.int32))
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    want, wm = make_train_step(cpu, microbatches=2, base_lr=1e-2)(state,
                                                                 batch)
    step = make_train_step(gpu, microbatches=2, base_lr=1e-2)
    on_card = _on(state, cuda)
    card_batch = {k: x.to(cuda) for k, x in batch.items()}
    step(on_card, card_batch)     # warm-up: RoPE's frequencies reach the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, gm = step(on_card, card_batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.params["embed"].is_cuda and got.opt.m["embed"].is_cuda
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]),
                               rtol=5e-3)
    np.testing.assert_allclose(float(gm["lr"]), float(wm["lr"]), rtol=1e-6)
    lr = float(wm["lr"])
    for name, w in want.params.items():
        g = got.params[name].cpu().float().numpy()
        w = w.float().numpy()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= 0.3 * lr + ulp).all(), name
        for what in ("m", "v"):
            a = getattr(got.opt, what)[name].cpu().numpy()
            b = getattr(want.opt, what)[name].numpy()
            assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max(), (what, name)
    # the optimizer alone, float32 in float32 out
    f32 = {k: x.float() for k, x in state.params.items()}
    grads = {k: torch.randn(x.shape, generator=torch.Generator()
                            .manual_seed(4)) * 1e-2 for k, x in f32.items()}
    pw, sw, iw = optimizer.adamw_update(f32, grads, state.opt)
    pg, sg, ig = optimizer.adamw_update(
        {k: x.to(cuda) for k, x in f32.items()},
        {k: x.to(cuda) for k, x in grads.items()}, _on(state, cuda).opt)
    for k in f32:
        for a, b in ((pg[k], pw[k]), (sg.m[k], sw.m[k]), (sg.v[k], sw.v[k])):
            assert (a.cpu() - b).abs().max() <= 1e-6 * b.abs().max(), k


def test_train_loop_recovers_exactly_on_card(cuda, tmp_path):
    """The reference's recovery test on the card: qwen2-1.5B's SMOKE
    config, 12 steps of 2 x 32 tokens with a checkpoint every 4, failures
    at steps 3 and 9; the final parameters equal the uninterrupted run's
    within atol 1e-6, each on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.runtime import FailureInjector, TrainLoop
    from repro_torch.train import make_train_step, train_state_init
    model = build_model(get_config("qwen2_1_5b", smoke=True))
    corpus = np.random.default_rng(0).integers(
        0, model.cfg.vocab, 40_000).astype(np.int32)
    step = make_train_step(model, base_lr=1e-3)

    def loop(path, injector=None):
        return TrainLoop(step, train_state_init(model),
                         lambda s: TokenPipeline(corpus, 2, 32, start_step=s),
                         str(tmp_path / path), ckpt_every=4,
                         injector=injector)

    clean = loop("clean").run(12)
    faulty_loop = loop("faulty", FailureInjector([3, 9]))
    faulty = faulty_loop.run(12)
    assert faulty_loop.restarts == 2
    for name, a in clean.params.items():
        assert faulty.params[name].is_cuda
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   faulty.params[name].float().cpu().numpy(),
                                   atol=1e-6, err_msg=name)


def _rows_close(got, want, tol, what):
    """Each element within ``tol`` plus ``tol`` times its row's largest
    |value| (the last axis), as ``tests/test_torch_hybrid.py`` holds them."""
    g, w = got.float().cpu(), want.float().cpu()
    row = w.abs().amax(dim=-1, keepdim=True)
    assert ((g - w).abs() <= tol + tol * row).all(), (
        what, float((g - w).abs().max()))


def test_moe_on_card_matches_cpu(cuda):
    """Identical bfloat16 inputs on the card and the CPU: deepseek's SMOKE
    config at 64 tokens (no drop) and dbrx's at 512 tokens with 128 slots
    an expert (drops). The same experts a token, the same token in every
    slot and the same copies kept; the output within rtol = atol = 2e-2
    (the combine adds in atomic order on the card) and aux within 1e-5;
    ``moe_ffn`` with the shared experts likewise."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, moe_a2a
    for arch, n, cap in (("deepseek_moe_16b", 64, None),
                         ("dbrx_132b", 512, 128)):
        cfg = get_config(arch, smoke=True)
        p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
        pg = {k: v.to(cuda) for k, v in p.items()}
        x = torch.randn((n, cfg.d_model),
                        generator=torch.Generator().manual_seed(1)).bfloat16()
        cap = cap or moe._capacity(n, cfg)
        want = moe_a2a._route(x, p, cfg, 0, cfg.n_experts, cap)
        got = moe_a2a._route(x.to(cuda), pg, cfg, 0, cfg.n_experts, cap)
        assert torch.equal(got.topi.sort(-1).values.cpu(),
                           want.topi.sort(-1).values), arch
        assert torch.equal(got.slot_tok.cpu(), want.slot_tok), arch
        kept = want.slot_w != 0
        assert torch.equal((got.slot_w != 0).cpu(), kept), arch
        assert (int(kept.sum()) < n * cfg.top_k) == (arch == "dbrx_132b")
        y, aux = moe_a2a._local_moe(x.to(cuda), pg, cfg, 0, cfg.n_experts,
                                    cap)
        wy, waux = moe_a2a._local_moe(x, p, cfg, 0, cfg.n_experts, cap)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   wy.float().numpy(), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
        xb = x[:64].reshape(2, 32, -1)
        y, aux = moe.moe_ffn(pg, xb.to(cuda), cfg)
        wy, waux = moe.moe_ffn(p, xb, cfg)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   wy.float().numpy(), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_mamba_on_card_matches_cpu(cuda):
    """jamba's SMOKE Mamba layer at S 129: ``mamba_forward``, the
    prefill's state and one ``mamba_decode`` step on the card against the
    CPU, each element within 2e-2 plus 2e-2 times its row's largest
    |value|, the ssm state within 2e-2 of its largest |value|."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, mamba
    cfg = get_config("jamba_v0_1_52b", smoke=True)
    p = mamba.init_mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    pg = {k: v.to(cuda) for k, v in p.items()}
    x = torch.randn((2, 130, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    _rows_close(mamba.mamba_forward(pg, x.to(cuda), cfg),
                mamba.mamba_forward(p, x, cfg), 2e-2, "mamba_forward")
    want, ws = blocks._mamba_prefill(p, x[:, :129], cfg)
    got, gs = blocks._mamba_prefill(pg, x[:, :129].to(cuda), cfg)
    _rows_close(got, want, 2e-2, "prefill")
    _rows_close(gs.conv, ws.conv, 2e-2, "conv window")
    assert float((gs.ssm.cpu() - ws.ssm).abs().max()) <= \
        2e-2 * float(ws.ssm.abs().max())
    want, ws = mamba.mamba_decode(p, x[:, 129:], cfg, ws)
    got, gs = mamba.mamba_decode(pg, x[:, 129:].to(cuda), cfg, gs)
    _rows_close(got, want, 2e-2, "decode")
    assert float((gs.ssm.cpu() - ws.ssm).abs().max()) <= \
        2e-2 * float(ws.ssm.abs().max())


def test_jamba_serving_on_card_matches_cpu(cuda):
    """jamba's SMOKE config: one set of weights made on the CPU and copied
    to the card; prefill of 2 x 64 (one attention kernel launch, layer 3)
    and 4 greedy decode steps fed the CPU's tokens, the card on the CPU's
    routing (``tests/torch_routing.py``: its own differing choices near
    ties, gap below 1e-2, ``tests/test_torch_hybrid.py``'s margin), logits each within 6e-2 plus 6e-2 times its
    row's largest |value| (``tests/test_torch_hybrid.py``'s tolerance
    against the reference)."""
    import copy

    from torch_routing import Routed, forced, recorded

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("jamba_v0_1_52b", smoke=True)
    cpu = build_model(cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 64), dtype=np.int32))
    with recorded() as probs:
        want = [cpu.prefill({"tokens": tok}, 68)]
        fed = []
        for t in range(4):
            fed.append(want[-1][0][:, -1].argmax(-1).to(torch.int32)[:, None])
            want.append(cpu.decode_step(fed[-1], want[-1][1], 64 + t))
    rec = Routed(cfg.top_k, probs)
    with forced(rec):
        ops.reset_launch_counts()
        got = [gpu.prefill({"tokens": tok.to(cuda)}, 68)]
        assert ops.launch_counts()["flash_attention"] == 1
        for t in range(4):
            got.append(gpu.decode_step(fed[t].to(cuda), got[-1][1], 64 + t))
    rec.check(1e-2, "jamba on the card against the CPU")
    for t, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g[0].float()).all()
        _rows_close(g[0], w[0], 6e-2, f"step {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_full_on_card(no_tf32, dtype):
    """The encoder's call at a ragged T: [2, 16, 200, 64] without the
    causal mask, no padding, one launch, against the plain version within
    ``_ATTN_TOL`` and ``SCALED_ERROR_TOL``; q drawn around +1 and k
    around -1, so that a key past T left unmasked would take most of a
    row's weight (as ``chip_smoke.py``'s ragged cases draw them)."""
    from repro_torch.kernels.flash_attention import (
        SCALED_ERROR_TOL, flash_attention, flash_attention_plain,
        scaled_error)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 16, 200, 64), generator=g) + c
               for c in (1.0, -1.0, 0.0))
    q, k, v = (x.to(no_tf32, getattr(torch, dtype)) for x in (q, k, v))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=False)
    assert float((got.float() - want.float()).abs().max()) <= _ATTN_TOL[dtype]
    assert scaled_error(got, want, v, False) <= SCALED_ERROR_TOL


def test_xlstm_on_card_matches_cpu(no_tf32):
    """xlstm-125M's SMOKE config (one period of 4 layers: 3 mLSTM, 1
    sLSTM): one set of weights made on the CPU and copied to the card;
    prefill of 2 x 100 (a ragged S: chunks of 64 and 36) and 4 greedy
    decode steps fed the CPU's tokens; no kernel launches; logits each
    within 0.15 plus 0.15 times its row's largest |value|
    (``tests/test_torch_xlstm.py``'s tolerance against the reference),
    each state tensor after the prefill within 0.1 of its largest
    |value|."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("xlstm_125m", smoke=True)
    cpu = build_model(cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(no_tf32)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 100), dtype=np.int32))
    want = [cpu.prefill({"tokens": tok})]
    ops.reset_launch_counts()
    got = [gpu.prefill({"tokens": tok.to(no_tf32)})]
    assert sum(ops.launch_counts().values()) == 0
    for gc, wc in zip(got[0][1], want[0][1]):
        for g, w in zip(gc, wc):
            assert float((g.cpu() - w).abs().max()) <= \
                0.1 * float(w.abs().max())
    for t in range(4):
        nxt = want[-1][0][:, -1].argmax(-1).to(torch.int32)[:, None]
        want.append(cpu.decode_step(nxt, want[-1][1], 100 + t))
        got.append(gpu.decode_step(nxt.to(no_tf32), got[-1][1], 100 + t))
    for t, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g[0].float()).all()
        _rows_close(g[0], w[0], 0.15, f"step {t}")


def test_encdec_on_card_matches_cpu(no_tf32):
    """seamless-m4t-large-v2's SMOKE config (2 encoder and 2 decoder
    layers): one set of weights made on the CPU and copied to the card;
    prefill of 2 utterances of 200 frames (a ragged T: the encoder's
    attention kernel once a layer, nothing else) and 4 greedy decode steps
    from a drawn start token fed the CPU's tokens; logits and the cross
    K/V each within 4e-2 plus 4e-2 times its row's largest |value| (twice
    ``tests/test_torch_encdec.py``'s tolerance against the reference)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("seamless_m4t_large_v2", smoke=True)
    cpu = build_model(cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(no_tf32)
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 200, cfg.d_model), dtype=np.float32)).bfloat16()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1),
                                        dtype=np.int32))
    wc = cpu.prefill({"frames": frames})
    ops.reset_launch_counts()
    gc = gpu.prefill({"frames": frames.to(no_tf32)})
    counts = ops.launch_counts()
    assert counts["flash_attention"] == cfg.n_enc_layers == \
        sum(counts.values())
    for key in ("cross_k", "cross_v"):
        _rows_close(gc[key], wc[key], 4e-2, key)
    for t in range(5):
        want, wc = cpu.decode_step(tok, wc, t)
        got, gc = gpu.decode_step(tok.to(no_tf32), gc, t)
        assert torch.isfinite(got.float()).all()
        _rows_close(got, want, 4e-2, f"step {t}")
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
