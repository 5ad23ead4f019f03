"""``segmented_minmax``'s kernel (``csrc/segmented_agg.cu``,
``segmented_minmax_kernel``: the sums' chunks, ranges and run folds over
``MinMaxOp``) as a numpy model on the CPU (``torch_diff.emulate_segmented``),
against the plain version (``segmented_minmax_plain``) and the reference's
Pallas kernel in interpret mode.

The model folds in key space (float32 values as int32 keys in the IEEE
total order, a NaN as the key that wins) and applies the output's updates
in a shuffled order, as the kernel's atomics land: the sign-split integer
atomics on the float bits (atomicMin on int for non-negative bits and
atomicMax on unsigned for negative ones, for min; the other two for max),
starting from the fill's +inf or -inf. There is no pass that maps keys
back over the outputs. Against the plain version every case is bit-exact,
NaNs (0xFFFFFFFF for min, 0x7FFFFFFF for max), -0.0 against +0.0 and
subnormals included. Against the reference the values are equal, a NaN
equal to a NaN: the reference keeps its input NaN's bits, and on the CPU
it flushes subnormals to zero, so its cases hold none.
"""

import numpy as np
import pytest
import torch
import torch_diff as td

import jax.numpy as jnp

from repro.kernels import segmented_agg as ref_seg
from repro_torch.kernels import segmented_agg as seg

I32 = np.iinfo(np.int32)


def _ids(kind, n, g, rng):
    """"sorted_dead_tail" (Q2's shape: sorted live ids, then dead rows at
    G), "sorted" (over [0, G], G dead), "unsorted" (over [-2, G + 3])."""
    if kind == "sorted_dead_tail":
        live = 2 * n // 3
        return np.concatenate([np.sort(rng.integers(0, g, live)),
                               np.full(n - live, g)]).astype(np.int32)
    if kind == "sorted":
        return np.sort(rng.integers(0, g + 1, n)).astype(np.int32)
    if kind == "unsorted":
        return rng.integers(-2, g + 4, n).astype(np.int32)
    raise ValueError(kind)


def _vals(dtype, n, rng, subnormals=True):
    """float32: random bit patterns with NaNs of both signs, +-inf, +-0 and
    (unless ``subnormals`` is False) subnormals planted; int32: the full
    range with both extremes planted."""
    if dtype == "int32":
        v = rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32)
        v[rng.random(n) < 0.05] = I32.max
        v[rng.random(n) < 0.05] = I32.min
        return v
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                        0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                        0x00000001, 0x807FFFFF], np.uint32)
    pick = rng.random(n) < 0.2
    bits[pick] = rng.choice(special, int(pick.sum()))
    v = bits.view(np.float32)
    if not subnormals:
        sub = (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)
        v = np.where(sub, np.float32(1.5), v).astype(np.float32)
    return v


def _plain(gids, vals, g, kind):
    return seg.segmented_minmax_plain(torch.from_numpy(gids),
                                      torch.from_numpy(vals), g, kind).numpy()


def _bits(x):
    return x.view(np.int32)


def _model(gids, vals, g, kind, grid, seed, id_offset=0, val_offset=0):
    return td.emulate_segmented(gids, vals, g, grid,
                                td.MinMaxOp(vals.dtype, kind), id_offset,
                                val_offset, rng=np.random.default_rng(seed))


def _check_costs(trace, sorted_ids):
    """No value read for a dead chunk, one for every live one; at most one
    flush a group and CTA; for sorted ids at most one update a run and
    range."""
    assert sorted(trace.value_chunks) == sorted(set(trace.live_chunks))
    flushes = [(b, k) for w, b, k, _ in trace.adds if w == "flush"]
    assert len(flushes) == len(set(flushes))
    if sorted_ids:
        folds = [(b, k) for w, b, k, _ in trace.adds if w == "fold"]
        assert len(folds) == len(set(folds))


# (ids, n, G, grid): G of 1, the largest shared G, the first global one and
# Q2's 2^20; sorted ids with a dead tail, sorted, unsorted; grids that set
# the ranges' length (2 steps at grid 64, 6 at grid 2, 8 at grid 1)
_CASES = [
    ("sorted", 3_000, 1, 2),
    ("unsorted", 2_001, 1, 1),
    ("sorted_dead_tail", 9_000, 8192, 3),
    ("sorted", 9_002, 8193, 3),
    ("unsorted", 6_003, 8193, 2),
    ("sorted_dead_tail", 12_000, 1 << 20, 2),
    ("sorted_dead_tail", 12_000, 300, 64),
    ("unsorted", 5_000, 41, 5),
    ("sorted", 12_000, 16, 1),
]


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("ids,n,g,grid", _CASES)
def test_model_matches_plain_bit_for_bit(ids, n, g, grid, dtype, kind):
    rng = np.random.default_rng(n + g + grid)
    gids, vals = _ids(ids, n, g, rng), _vals(dtype, n, rng)
    got, trace = _model(gids, vals, g, kind, grid, seed=n)
    want = _plain(gids, vals, g, kind)
    assert got.dtype == want.dtype and got.shape == (g,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    _check_costs(trace, ids.startswith("sorted"))


@pytest.mark.parametrize("kind", ["min", "max"])
def test_model_nan_bits_are_the_plain_versions(kind):
    """A NaN of either sign in a group gives 0xFFFFFFFF for min and
    0x7FFFFFFF for max, in any order of the updates; a group of both zeros
    gives -0.0 for min, +0.0 for max."""
    gids = np.repeat(np.arange(6, dtype=np.int32), 40)
    rng = np.random.default_rng(3)
    vals = rng.normal(size=240).astype(np.float32)
    vals[5] = np.uint32(0x7FC00000).view(np.float32)
    vals[45] = np.uint32(0xFFC00001).view(np.float32)
    vals[80:120] = np.where(np.arange(40) % 2, 0.0, -0.0)
    vals[130] = np.inf
    vals[170] = -np.inf
    for seed in range(5):
        got, _ = _model(gids, vals, 6, kind, grid=1, seed=seed)
        want = _plain(gids, vals, 6, kind)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        nan = -1 if kind == "min" else 0x7FFFFFFF
        assert _bits(got)[0] == _bits(got)[1] == nan
        assert _bits(got)[2] == (np.int32(-2 ** 31) if kind == "min" else 0)


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("ids,n,g", [("sorted_dead_tail", 3_000, 300),
                                     ("unsorted", 3_001, 41),
                                     ("sorted", 2_000, 8193),
                                     ("unsorted", 1_500, 1)])
def test_model_matches_pallas(ids, n, g, dtype, kind):
    rng = np.random.default_rng(7 * n + g)
    gids = _ids(ids, n, g, rng)
    vals = _vals(dtype, n, rng, subnormals=False)
    got, _ = _model(gids, vals, g, kind, grid=2, seed=g)
    want = np.asarray(ref_seg.segmented_minmax(
        jnp.asarray(gids), jnp.asarray(vals), g, kind, interpret=True))
    np.testing.assert_array_equal(got, want)
    if dtype == "float32":
        # +-0 and +-inf bit for bit; a NaN where the reference has one
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


# n % 4 of 0-3; ids 1-3 rows past a 16-byte boundary, the values misaligned
# differently from the ids or alike
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,id_offset,val_offset", [
    (4_097, 1, 1), (4_098, 2, 0), (4_099, 3, 2), (4_096, 1, 3),
    (3, 2, 2)])
def test_model_views_at_row_offsets(n, id_offset, val_offset, dtype):
    rng = np.random.default_rng(11 * n + id_offset + 5 * val_offset)
    g = 50
    gids = np.sort(rng.integers(0, g + 1, n)).astype(np.int32)
    vals = _vals(dtype, n, rng)
    for kind in ("min", "max"):
        got, trace = _model(gids, vals, g, kind, grid=2, seed=n,
                            id_offset=id_offset, val_offset=val_offset)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_plain(gids, vals, g, kind)))
        _check_costs(trace, True)


def test_model_reads_no_value_of_a_dead_chunk():
    """Q2's shape: the dead tail's chunks load no value."""
    n, g = 40_000, 1 << 20
    gids = np.full(n, g, np.int32)
    gids[:1_001] = np.arange(1_001) * 3
    vals = np.full(n, np.inf, np.float32)
    vals[:1_001] = np.arange(1_001, dtype=np.float32) + 1.0
    got, trace = _model(gids, vals, g, "min", grid=7, seed=1)
    np.testing.assert_array_equal(_bits(got), _bits(_plain(gids, vals, g,
                                                           "min")))
    assert sorted(trace.value_chunks) == list(range(-(-1_001 // 4)))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_model_empty_groups_hold_the_identity(dtype):
    """Every group is written once: a group with no row holds the fill's
    identity (+-inf, or the int32 extremes); no rows at all, the same."""
    for n in (0, 10):
        gids = np.full(n, 7, np.int32)
        vals = np.ones(n, np.dtype(dtype))
        for kind in ("min", "max"):
            got, _ = _model(gids, vals, 8, kind, grid=1, seed=0)
            want = _plain(gids, vals, 8, kind)
            np.testing.assert_array_equal(_bits(got), _bits(want))
