"""The exchange's metadata pass (``repro_torch.kernels.radix_histogram.
partition_histogram``) against the reference on the same seeded numpy
inputs: each source's ``relational.partition_ids`` (a dead row's id set to
W) and the reference's ``radix_histogram`` Pallas kernel (interpret mode)
over the (source, destination) bins. The plain version runs here; the
CUDA kernel's chunk grid and uint32 hash are held to it through
``torch_diff.emulate_partition``, on the CPU tensors' own addresses.
Integers throughout, so every comparison is exact."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import emulate_partition  # noqa: E402

from repro.core import relational as ref_rel  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels.radix_histogram import (  # noqa: E402
    partition_histogram, partition_histogram_plain)

# the module (``repro.kernels`` re-exports a function of the same name)
ref_hist = importlib.import_module("repro.kernels.radix_histogram")
I32 = np.iinfo(np.int32)


def _ints(rng, n, off=0):
    a = rng.integers(I32.min, I32.max, n + off, dtype=np.int64)
    a = a.astype(np.int32)
    a[off:off + min(n, 4)] = [0, -1, I32.min, I32.max][:min(n, 4)]
    return a[off:]


def _lanes(rng, n, width, off=0):
    return rng.integers(0, 256, (n + off, width)).astype(np.uint8)[off:]


def _source(case, n, rng, src):
    """(key columns as numpy arrays, validity) of one source."""
    valid = rng.random(n) < 0.7
    if case == "one_int":
        return [_ints(rng, n)], valid
    if case == "three_ints":
        return [_ints(rng, n), _ints(rng, n) % 97, _ints(rng, n)], valid
    if case == "bytes":
        return [_lanes(rng, n, 18), _ints(rng, n)], valid
    if case == "bool":
        return [rng.random(n) < 0.5], valid
    if case == "int64":
        return [rng.integers(I32.min, I32.max, n, dtype=np.int64)], valid
    if case == "float":
        return [(rng.random(n) * 2e6 - 1e6).astype(np.float32)], valid
    if case == "all_dead":
        return [_ints(rng, n)], np.zeros(n, bool)
    if case == "one_row":
        return [_ints(rng, 1)], np.ones(1, bool)
    if case == "offset_slices":        # views 1-3 rows past their bases
        off = 1 + src % 3
        buf = np.zeros(n + 4, bool)
        buf[off:off + n] = valid
        return [_ints(rng, n, off), _lanes(rng, n, 7, 3 - src % 3)], \
            buf[off:off + n]
    raise AssertionError(case)


_CASES = ("one_int", "three_ints", "bytes", "bool", "int64", "float",
          "all_dead", "one_row", "offset_slices")


def _inputs(case, w, seed):
    rng = np.random.default_rng(seed)
    sizes = [(37, 300, 1, 129)[s % 4] for s in range(w)]
    return [_source(case, n, rng, s) for s, n in enumerate(sizes)]


def _reference(sources, w):
    pids, bins = [], []
    for src, (cols, valid) in enumerate(sources):
        pid = np.asarray(ref_rel.partition_ids(
            [jnp.asarray(c) for c in cols], jnp.asarray(valid), w))
        pid = np.where(valid, pid, w).astype(np.int32)
        pids.append(pid)
        bins.append(np.where(pid < w, pid + src * w, w * w).astype(np.int32))
    counts = np.asarray(ref_hist.radix_histogram(
        jnp.asarray(np.concatenate(bins)), w * w, interpret=True))
    return np.concatenate(pids), counts.reshape(w, w)


def _port(sources):
    return ([[torch.from_numpy(c) for c in cols] for cols, _ in sources],
            [torch.from_numpy(v) for _, v in sources])


@pytest.mark.parametrize("w", [1, 2, 4, 8])
@pytest.mark.parametrize("case", _CASES)
def test_partition_histogram_matches_reference(case, w):
    sources = _inputs(case, w, seed=w * 100 + len(case))
    want_pids, want_counts = _reference(sources, w)
    keys, valid = _port(sources)
    for fn in (partition_histogram_plain, partition_histogram):
        pids, counts = fn(keys, valid, w)
        assert pids.dtype == torch.int32 and counts.dtype == torch.int32
        assert counts.shape == (w, w)
        np.testing.assert_array_equal(pids.numpy(), want_pids)
        np.testing.assert_array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("w", [1, 3, 4, 8])
@pytest.mark.parametrize("case", ["one_int", "three_ints", "bytes",
                                  "all_dead", "one_row", "offset_slices"])
def test_kernel_model_matches_plain(case, w):
    """The kernel's walk (``emulate_partition``) gives the plain version's
    pids and counts, with the flat pids at each 4-byte offset of a 16-byte
    boundary."""
    sources = _inputs(case, w, seed=w + 7 * len(case))
    keys, valid = _port(sources)
    want_pids, want_counts = partition_histogram_plain(keys, valid, w)
    for pids_addr in (0, 4, 8, 12):
        pids, counts = emulate_partition(keys, valid, w, pids_addr)
        np.testing.assert_array_equal(pids, want_pids.numpy())
        np.testing.assert_array_equal(counts, want_counts.numpy())


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 131, 4099])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_kernel_model_covers_ragged_views(n, off):
    """Sources of n rows at views ``off`` rows past a boundary (keys and
    validity differently), at W = 4: every row once, aligned whole
    loads, the plain version's result."""
    rng = np.random.default_rng(n * 4 + off)
    sources = []
    for s in range(4):
        buf = rng.random(n + 4) < 0.6
        sources.append(([_ints(rng, n, (off + s) % 4)],
                        buf[(off + 2 * s) % 4:(off + 2 * s) % 4 + n]))
    keys, valid = _port(sources)
    want_pids, want_counts = partition_histogram_plain(keys, valid, 4)
    pids, counts = emulate_partition(keys, valid, 4)
    np.testing.assert_array_equal(pids, want_pids.numpy())
    np.testing.assert_array_equal(counts, want_counts.numpy())


def test_partition_histogram_counts_each_cast_column():
    """A 1-D key column other than int32 is cast once, counted as one
    ``partition_cast`` dispatch; int32 and bytes columns are not."""
    rng = np.random.default_rng(3)
    sources = [([rng.random(50) < 0.5, _ints(rng, 50).astype(np.int64),
                 _ints(rng, 50), _lanes(rng, 50, 4)], rng.random(50) < 0.5)
               for _ in range(2)]
    keys, valid = _port(sources)
    dispatch = {}
    kernel_ops.reset_launch_counts()
    with kernel_ops.collect_dispatches(dispatch):
        partition_histogram(keys, valid, 2)
    assert dispatch == {"partition_cast": 4}
    assert kernel_ops.launch_counts()["radix_histogram"] == 0   # CPU: plain


def test_partition_histogram_refuses_a_source_count_other_than_w():
    keys, valid = _port(_inputs("one_int", 3, seed=1))
    with pytest.raises(ValueError):
        partition_histogram(keys, valid, 4)
