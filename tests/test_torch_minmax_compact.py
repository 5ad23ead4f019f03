"""The port's compaction and min/max kernels (``repro_torch.kernels``
``block_prefix_sum`` and ``segmented_agg.segmented_minmax``) and the code
that calls them (``TorchTable.compact``, ``relational.segment_agg``)
against the reference, on inputs made from a seed with numpy.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are checked by ``test_torch_gpu.py`` (skipped without a card) and by
``chip_smoke.py``. Both kernels are exact by contract (integer scans, and
min/max, which do not depend on order), so every comparison here is
bit-exact; a NaN compares equal to a NaN.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import port_schema  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.kernels import segmented_agg as ref_seg  # noqa: E402
from repro.kernels.ops import record_kernels as ref_record  # noqa: E402
from repro.kernels.ops import use_pallas  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels import segmented_agg as seg  # noqa: E402
from repro_torch.kernels.block_prefix_sum import block_prefix_sum  # noqa: E402,E501

# the module (``repro.kernels`` re-exports a function of the same name)
ref_bps = importlib.import_module("repro.kernels.block_prefix_sum")
I32 = np.iinfo(np.int32)


# ---------------------------------------------------------------------------
# block_prefix_sum
# ---------------------------------------------------------------------------

def _mask(case, seed):
    rng = np.random.default_rng(seed)
    n = {"one_row": 1, "one_block": 1024, "ragged": 3001, "all_set": 2500,
         "none_set": 2500, "sparse": 5000}[case]
    p = {"all_set": 1.0, "none_set": 0.0, "sparse": 0.02}.get(case, 0.5)
    return rng.random(n) < p


_MASK_CASES = ["one_row", "one_block", "ragged", "all_set", "none_set",
               "sparse"]


@pytest.mark.parametrize("case", _MASK_CASES)
def test_block_prefix_sum_matches_reference(case):
    mask = _mask(case, seed=len(case))
    want_pos, want_total = ref_bps.block_prefix_sum(jnp.asarray(mask),
                                                    interpret=True)
    oracle_pos, oracle_total = ref_oracle.block_prefix_sum(jnp.asarray(mask))
    pos, total = block_prefix_sum(torch.from_numpy(mask))
    assert pos.dtype == torch.int32 and total.dtype == torch.int32
    assert total.dim() == 0
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(oracle_pos))
    assert int(total) == int(want_total) == int(oracle_total) == mask.sum()


def test_block_prefix_sum_of_no_rows():
    pos, total = block_prefix_sum(torch.zeros(0, dtype=torch.bool))
    assert pos.shape == (0,) and int(total) == 0


def test_cpu_wrappers_launch_nothing():
    kernel_ops.reset_launch_counts()
    used = set()
    with kernel_ops.record_kernels(used):
        block_prefix_sum(torch.ones(10, dtype=torch.bool))
    g = torch.zeros(10, dtype=torch.int32)
    seg.segmented_minmax(g, torch.ones(10), 4, "min")
    seg.segmented_minmax(g, g, 4, "max")
    assert used == {"compact"}
    assert all(v == 0 for v in kernel_ops.launch_counts().values())


# ---------------------------------------------------------------------------
# TorchTable.compact
# ---------------------------------------------------------------------------

_TABLE_SCHEMA = {"i": rdt.INT32, "f": rdt.FLOAT32, "b": rdt.BOOL,
                 "s": rdt.bytes_(5), "d": rdt.DATE32}


def _tables(n, seed):
    rng = np.random.default_rng(seed)
    data = {"i": rng.integers(I32.min, I32.max, n, dtype=np.int64)
            .astype(np.int32),
            "f": rng.normal(size=n).astype(np.float32),
            "b": rng.random(n) < 0.5,
            "s": rng.integers(0, 255, (n, 5)).astype(np.uint8),
            "d": rng.integers(8000, 10000, n).astype(np.int32)}
    ref = DeviceTable.from_numpy(data, _TABLE_SCHEMA)
    port = TorchTable.from_numpy(data, port_schema(_TABLE_SCHEMA),
                                 device="cpu")
    return ref, port


@pytest.mark.parametrize("case", ["ragged", "all_set", "none_set", "sparse"])
def test_compact_matches_pallas_device_table(case):
    mask = _mask(case, seed=7)
    ref_t, port_t = _tables(len(mask), seed=len(case))
    used = set()
    with use_pallas(), ref_record(used):
        want = ref_t.filter(jnp.asarray(mask)).compact()
    assert used == {"compact"}      # the reference's block_prefix_sum path
    got = port_t.filter(torch.from_numpy(mask)).compact()
    n = int(mask.sum())
    want_valid = np.asarray(want.validity)
    np.testing.assert_array_equal(got.validity.numpy(), want_valid)
    assert want_valid[:n].all() and not want_valid[n:].any()
    # valid rows land exactly where the reference puts them, in order
    for name in want.column_names:
        np.testing.assert_array_equal(got.columns[name].numpy()[:n],
                                      np.asarray(want.columns[name])[:n],
                                      err_msg=name)


def test_compact_table_dispatches_compact():
    _, port_t = _tables(300, seed=2)
    counts = {}
    with kernel_ops.collect_dispatches(counts):
        out = ops.compact_table(port_t.filter(torch.arange(300) % 3 == 0))
    assert counts == {"compact": 1}
    np.testing.assert_array_equal(out.columns["i"][:100].numpy(),
                                  port_t.columns["i"][::3].numpy())


# ---------------------------------------------------------------------------
# segmented_minmax
# ---------------------------------------------------------------------------

def _minmax_inputs(case, dtype, seed):
    """(gids, values, G): sorted ids with dead rows carrying id G, as
    ``segment_agg`` hands them over; some groups empty. In the
    ``signed_zeros`` case most groups hold only -0.0 and +0.0, mixed."""
    rng = np.random.default_rng(seed)
    n, g = {"small": (700, 12), "many_groups": (4000, 3000),
            "one_group": (2048, 1), "extremes": (1500, 40),
            "signed_zeros": (3000, 30)}[case]
    gids = np.sort(rng.integers(0, g + 1, n)).astype(np.int32)
    gids[gids == g // 2] = g            # one group left empty
    if dtype == np.float32:
        vals = rng.normal(0, 100, n).astype(np.float32)
        if case == "extremes":
            vals[::7] = np.inf
            vals[3::11] = -np.inf
            vals[5] = np.float32(np.finfo(np.float32).max)
        if case == "signed_zeros":
            zeros = gids % 5 != 0
            vals[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    else:
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
        if case == "extremes":
            vals[::7] = I32.max
            vals[3::11] = I32.min
    return gids, vals, g


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("case", ["small", "many_groups", "one_group",
                                  "extremes", "signed_zeros"])
def test_segmented_minmax_matches_pallas_exactly(case, dtype, kind):
    gids, vals, g = _minmax_inputs(case, dtype, seed=len(case))
    want = ref_seg.segmented_minmax(jnp.asarray(gids), jnp.asarray(vals), g,
                                    kind, interpret=True)
    got = seg.segmented_minmax(torch.from_numpy(gids), torch.from_numpy(vals),
                               g, kind)
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (g,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bit for bit: a group of mixed zeros gives -0.0 for min and +0.0 for
    # max, in the port as in the reference
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    # the empty group holds the identity
    ident = (np.inf if kind == "min" else -np.inf) if dtype == np.float32 \
        else (I32.max if kind == "min" else I32.min)
    assert got.numpy()[g // 2] == ident


@pytest.mark.parametrize("kind", ["min", "max"])
def test_segmented_minmax_propagates_nan_like_the_reference(kind):
    gids = np.array([0, 0, 0, 1, 1, 2], np.int32)
    vals = np.array([1.0, np.nan, -3.0, 2.0, 5.0, np.nan], np.float32)
    want = np.asarray(ref_seg.segmented_minmax(
        jnp.asarray(gids), jnp.asarray(vals), 3, kind, interpret=True))
    got = seg.segmented_minmax(torch.from_numpy(gids), torch.from_numpy(vals),
                               3, kind).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


def test_segmented_minmax_drops_ids_out_of_range():
    gids = np.array([-3, 0, 1, 4, 9], np.int32)
    vals = np.array([-100, 5, 6, -200, -300], np.int32)
    got = seg.segmented_minmax(torch.from_numpy(gids), torch.from_numpy(vals),
                               4, "min").numpy()
    np.testing.assert_array_equal(got, [5, 6, I32.max, I32.max])
