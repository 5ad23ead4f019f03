"""The port's kernels (``repro_torch.kernels.segmented_agg`` and
``repro_torch.core.fused``) against the reference's Pallas kernels in
interpret mode, on inputs made from a seed with numpy.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are checked by ``test_torch_gpu.py`` (skipped without a card)
and by ``chip_smoke.py``. The fused kernel's register
program is also run through ``torch_diff.emulate``, which follows the CUDA
kernel's 32-bit semantics, so the lowering is tested here too.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import (assert_tables_equal, emulate, port_schema,  # noqa: E402
                        seeded_columns, stage_cases, to_port)

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import fused as ref_fused  # noqa: E402
from repro.core.expr import col, date_lit, lit  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import segmented_agg as ref_seg  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro.tpch import schema as ref_schema  # noqa: E402
from repro_torch.core import fused  # noqa: E402
from repro_torch.core.expr import Expr  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import segmented_agg as seg  # noqa: E402

CSRC = Path(fused.__file__).resolve().parents[1] / "kernels" / "csrc"


# ---------------------------------------------------------------------------
# segmented sums
# ---------------------------------------------------------------------------

# (rows, groups): one row block, ids past G, the slab loop (G > 1024), empty
_SEG_CASES = [(1000, 16), (3000, 41), (5000, 2500), (0, 8)]


def _seg_inputs(n, g, seed):
    rng = np.random.default_rng(seed)
    gids = rng.integers(-2, g + 4, n).astype(np.int32)   # some dropped
    return gids, rng


@pytest.mark.parametrize("n,g", _SEG_CASES)
def test_segmented_sum_matches_pallas(n, g):
    gids, rng = _seg_inputs(n, g, seed=n + g)
    vals = rng.normal(0, 10, n).astype(np.float32)
    want = ref_seg.segmented_sum(jnp.asarray(gids), jnp.asarray(vals), g,
                                 interpret=True)
    got = seg.segmented_sum(torch.from_numpy(gids), torch.from_numpy(vals), g)
    assert got.dtype == torch.float32 and got.shape == (g,)
    # float32 sums in another order: rtol 1e-5 of the values' magnitude
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(vals).sum()), 1))


@pytest.mark.parametrize("n,g", _SEG_CASES)
def test_segmented_int_sum_matches_pallas_exactly(n, g):
    gids, rng = _seg_inputs(n, g, seed=7 * n + g)
    # values near 2^30: every group's sum wraps past 2^31
    vals = rng.integers(1 << 29, 1 << 30, n).astype(np.int32)
    want = ref_seg.segmented_int_sum(jnp.asarray(gids), jnp.asarray(vals), g,
                                     interpret=True)
    got = seg.segmented_int_sum(torch.from_numpy(gids),
                                torch.from_numpy(vals), g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segmented_int_sum_wraps_past_int32():
    gids = np.zeros(4, np.int32)
    vals = np.full(4, 1 << 30, np.int32)
    got = seg.segmented_int_sum(torch.from_numpy(gids),
                                torch.from_numpy(vals), 1)
    assert int(got[0]) == 0        # 4 * 2^30 wraps to 0 in int32
    want = ref_seg.segmented_int_sum(jnp.asarray(gids), jnp.asarray(vals), 1,
                                     interpret=True)
    assert int(want[0]) == 0


def test_cpu_wrappers_launch_nothing():
    ops.reset_launch_counts()
    g = torch.zeros(10, dtype=torch.int32)
    seg.segmented_sum(g, torch.ones(10), 4)
    seg.segmented_int_sum(g, torch.ones(10, dtype=torch.int32), 4)
    assert all(v == 0 for v in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# fused morsel program
# ---------------------------------------------------------------------------

def _query_stages(q):
    """Q's fused stages (scan filter, then projection), reference side."""
    plan = ref_queries.build_query(q, ref_dbgen.load_catalog(sf=0.001))
    while type(plan).__name__ != "Project":
        plan = plan.child
    scan = plan.child
    return list(scan.columns), [(scan.filter, None),
                                (None, tuple(plan.projections))]


@pytest.fixture(scope="module")
def lineitem():
    data = ref_dbgen.generate(sf=0.002)["lineitem"]
    return {c: v[:3000] for c, v in data.items()}


def _both_tables(data, schema, capacity=None):
    ref = DeviceTable.from_numpy(data, schema, capacity=capacity)
    port = TorchTable.from_numpy(data, port_schema(schema), capacity=capacity,
                                 device="cpu")
    return ref, port


@pytest.mark.parametrize("q", [1, 6])
def test_fused_plain_matches_pallas(q, lineitem):
    cols, stages = _query_stages(q)
    data = {c: lineitem[c] for c in cols}
    schema = {c: ref_schema.LINEITEM[c] for c in cols}
    # capacity not a multiple of the 1024-row block: padded rows are dead
    ref_t, port_t = _both_tables(data, schema, capacity=3100)
    want, _, _ = ref_fused.fused_morsel_program(ref_t, stages, interpret=True)
    got, _, _ = fused.fused_morsel_program(port_t, to_port(stages))
    # the reference's pytree flattening sorts columns by name
    assert sorted(got.column_names) == sorted(want.column_names)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    for name in want.column_names:
        a, b = got.columns[name].numpy(), np.asarray(want.columns[name])
        assert a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            # elementwise float32 ops round alike; allow XLA's reassociation
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("q", [1, 6])
def test_fused_program_emulates_plain_on_query_stages(q, lineitem):
    cols, stages = _query_stages(q)
    data = {c: lineitem[c] for c in cols}
    port_t = TorchTable.from_numpy(
        data, port_schema({c: ref_schema.LINEITEM[c] for c in cols}),
        device="cpu")
    stages = to_port(stages)
    program = fused.lower_stages(port_t, stages)
    assert_tables_equal(emulate(program, port_t),
                        fused.apply_stages(port_t, stages))


_SCHEMA = {"i": rdt.INT32, "j": rdt.INT32, "f": rdt.FLOAT32,
           "g": rdt.FLOAT32, "b": rdt.BOOL, "d": rdt.DATE32}

_STAGE_CASES = stage_cases(col, lit, date_lit)


@pytest.mark.parametrize("case", sorted(_STAGE_CASES))
def test_fused_program_emulates_plain(case):
    data = seeded_columns(2000, seed=len(case))
    _, port_t = _both_tables(data, _SCHEMA)
    port_t = port_t.filter(torch.from_numpy(np.arange(2000) % 7 != 3))
    stages = to_port(_STAGE_CASES[case])
    program = fused.lower_stages(port_t, stages)
    assert program.code.shape[0] <= fused.LIMITS["kMaxInstr"]
    assert_tables_equal(emulate(program, port_t),
                        fused.apply_stages(port_t, stages))


@pytest.mark.parametrize("case", ["arith_f32", "promotion", "isin",
                                  "three_stages"])
def test_fused_plain_matches_pallas_on_edge_values(case):
    data = seeded_columns(1500, seed=3)
    ref_t, port_t = _both_tables(data, _SCHEMA)
    stages = _STAGE_CASES[case]
    want, _, _ = ref_fused.fused_morsel_program(ref_t, stages, interpret=True)
    got, _, _ = fused.fused_morsel_program(port_t, to_port(stages))
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    for name in want.column_names:
        a, b = got.columns[name].numpy(), np.asarray(want.columns[name])
        assert a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_lowering_refuses_what_the_kernel_cannot_run():
    data = {"s": np.zeros((8, 4), np.uint8), "i": np.arange(8, dtype=np.int32)}
    t = TorchTable.from_numpy(data, port_schema({"s": rdt.bytes_(4),
                                                 "i": rdt.INT32}),
                              device="cpu")
    pcol = to_port(col("s"))
    # a bytes column that a stage only carries passes through: the kernel
    # never loads it, and the output column is the input tensor, as the
    # plain version's ColumnRef gives it
    for stages in ([(None, (("s", pcol),))],
                   [(to_port(col("i") > lit(2)), None)]):
        program = fused.lower_stages(t, stages)
        assert "s" not in program.in_names
        assert dict(zip(program.out_names, program.out_alias))["s"] == "s"
        got = emulate(program, t)
        assert_tables_equal(got, fused.apply_stages(t, stages))
        assert got.columns["s"] is t.columns["s"]

    class Opaque(Expr):
        """A node the lowering has no instruction for."""

    with pytest.raises(NotImplementedError):
        fused.lower_stages(t, [(None, (("x", Opaque() + 1),))])
    # a probe on a bytes key: the table takes exact keys (a hashed one
    # probes the sorted-key join)
    probe = dict(tk=torch.full((8,), -1, dtype=torch.int32),
                 tv=torch.zeros(8, dtype=torch.int32), probe_keys=("s",),
                 pack=None, empty_key=-1, max_probes=8)
    with pytest.raises(NotImplementedError):
        fused.fused_morsel_program(t, [], probe=probe)
    with pytest.raises(NotImplementedError):
        fused.lower_stages(t, [], probe_keys=("s",))


def test_opcodes_and_limits_match_cuda_source():
    # the interpreter both fused kernels run, opcodes and limits included
    src = (CSRC / "fused_interp.cuh").read_text()
    enum = dict((k, int(v)) for k, v in
                re.findall(r"OP_(\w+)\s*=\s*(\d+)", src))
    assert enum == fused.OPS
    for name, value in fused.LIMITS.items():
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # and every constant of the header is mirrored (the tile layout's too)
    consts = dict((k, int(v)) for k, v in
                  re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert consts == fused.LIMITS
    assert consts["kTileRows"] == consts["kThreads"] * consts["kRowsPerThread"]
    assert consts["kUniformBase"] >= consts["kMaxRegs"]
