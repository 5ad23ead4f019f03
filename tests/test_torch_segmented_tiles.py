"""The segmented sums' partition (``csrc/segmented_agg.cu``,
``segmented_sum_kernel``) as a numpy model on the CPU
(``torch_diff.emulate_segmented`` with ``SumOp``), against the plain
versions (``segmented_sum_plain``, ``segmented_int_sum_plain``) and the
reference's Pallas kernels in interpret mode.

The model follows the kernel step by step: 4-row chunks aligned to the
ids' 16-byte boundaries (a scalar head for a base at a row offset, a
scalar tail for n % 4 rows), no value load for a chunk whose ids are all
dead, warp steps of 32 chunks, ranges of 2 to 8 steps dealt to the warps
in turn, two steps loaded before the first fold (and skipped when they
hold no live id), a thread's runs folded
in registers, a step's 32 chunks joined by a segmented scan with the
shuffles' semantics, each step's runs joined onto the range's, and the
range's first and last runs added at its end; per-CTA shared partials
flushed at the end for G <= 8192. It records every add and every value
load, so the tests also hold the design to its costs: no value read for a
dead chunk, and for sorted ids at most one add per run and range (a range
is at most a CTA tile's 1024 rows).

Int sums are exact (unsigned arithmetic, wrapping); float sums are held
to the tolerance of ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch
import torch_diff as td

import jax.numpy as jnp

from repro.kernels import segmented_agg as ref_seg
from repro_torch.kernels import segmented_agg as seg

CHUNK = td.SEG_CHUNK
RANGE_STEPS = td.SEG_RANGE_STEPS
TILE = td.SEG_THREADS * CHUNK


def model(gids, vals, num_groups, grid, id_offset=0, val_offset=0):
    """One launch of ``segmented_sum_kernel`` on ``grid`` CTAs (the launch
    takes min(resident CTAs, tiles)), with the ids' base ``id_offset`` and
    the values' ``val_offset`` rows past a 16-byte boundary: (out, trace),
    ``torch_diff.emulate_segmented`` with the sums' ``SumOp``."""
    return td.emulate_segmented(gids, vals, num_groups, grid,
                                td.SumOp(vals.dtype), id_offset, val_offset)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _ids(kind, n, g, rng):
    """Group ids of a case kind: "sorted_dead_tail" (a merge: sorted live
    ids, then the sentinel G), "sorted" (sorted over [0, G], G dead),
    "unsorted" (uniform over [-2, G + 3]), "all_dead" (G, -1, 2^31 - 1),
    "stacked" (``batch._stacked_segment_agg``'s remap of 4 lanes: a lane's
    sorted ids, member-dead rows as the sentinel)."""
    if kind == "sorted_dead_tail":
        live = n // 3
        return np.concatenate([np.sort(rng.integers(0, g, live)),
                               np.full(n - live, g)]).astype(np.int32)
    if kind == "sorted":
        return np.sort(rng.integers(0, g + 1, n)).astype(np.int32)
    if kind == "unsorted":
        return rng.integers(-2, g + 4, n).astype(np.int32)
    if kind == "all_dead":
        return rng.choice(np.array([g, -1, 2 ** 31 - 1], np.int64),
                          n).astype(np.int32)
    if kind == "stacked":
        lanes = 4
        local = g // lanes
        per = -(-n // lanes)
        gids = np.sort(rng.integers(0, local + 1, per)).astype(np.int32)
        member = (rng.random((lanes, per)) < 0.5) & (gids < local)[None, :]
        lane = local * np.arange(lanes, dtype=np.int32)[:, None]
        stacked = np.where(member, gids[None, :] + lane, lanes * local)
        return stacked.reshape(-1)[:n].astype(np.int32)
    raise ValueError(kind)


def _vals(dtype, n, rng):
    if dtype == "int32":
        # near 2^30: sums wrap past 2^31
        return rng.integers(1 << 29, 1 << 30, n).astype(np.int32)
    return rng.normal(0, 10, n).astype(np.float32)


def _plain(gids, vals, g):
    fn = (seg.segmented_int_sum_plain if vals.dtype == np.int32
          else seg.segmented_sum_plain)
    return fn(torch.from_numpy(gids), torch.from_numpy(vals), g).numpy()


def _reference(gids, vals, g):
    fn = (ref_seg.segmented_int_sum if vals.dtype == np.int32
          else ref_seg.segmented_sum)
    return np.asarray(fn(jnp.asarray(gids), jnp.asarray(vals), g,
                         interpret=True))


def _assert_sums(got, want, vals):
    if vals.dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        # float32 sums in another order: rtol 1e-5 of the values' magnitude
        np.testing.assert_allclose(
            got, want, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(vals).sum()), 1))


def _check_costs(gids, g, trace, sorted_ids):
    """No value read for a dead chunk, one for every live one; at most one
    flush per group and CTA; for sorted ids at most one add per run and
    range (a sorted input's run is all the live rows of its group)."""
    assert sorted(trace.value_chunks) == sorted(set(trace.live_chunks))
    flushes = [(b, k) for w, b, k, _ in trace.adds if w == "flush"]
    assert len(flushes) == len(set(flushes))
    if sorted_ids:
        folds = [(b, k) for w, b, k, _ in trace.adds if w == "fold"]
        assert len(folds) == len(set(folds))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

# (kind, n, G, grid): a merge's shape cut down (sorted, dead tail; global
# adds above 8192 groups), sorted runs across steps and ranges, unsorted,
# all dead, stacked lanes; the grid sets the ranges' length (2 steps at
# grid 64, 6 at grid 2, 8 at grid 1 with two ranges for some warps)
_CASES = [
    ("sorted_dead_tail", 20_000, 9000, 4),
    ("sorted_dead_tail", 20_000, 300, 3),
    ("sorted", 12_000, 16, 1),
    ("sorted", 12_000, 16, 2),
    ("sorted", 12_000, 16, 64),
    ("sorted", 9_001, 8192, 3),
    ("sorted", 9_002, 8193, 3),
    ("unsorted", 6_003, 41, 2),
    ("unsorted", 5_000, 2500, 5),
    ("unsorted", 5_000, 8193, 1),
    ("all_dead", 4_097, 64, 2),
    ("stacked", 16_000, 64, 3),
]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind,n,g,grid", _CASES)
def test_model_matches_plain(kind, n, g, grid, dtype):
    rng = np.random.default_rng(n + g + grid)
    gids, vals = _ids(kind, n, g, rng), _vals(dtype, n, rng)
    got, trace = model(gids, vals, g, grid)
    _assert_sums(got, _plain(gids, vals, g), vals)
    _check_costs(gids, g, trace, kind.startswith("sorted"))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind,n,g", [("sorted_dead_tail", 3_000, 300),
                                      ("unsorted", 3_001, 41),
                                      ("stacked", 4_000, 64)])
def test_model_matches_pallas(kind, n, g, dtype):
    rng = np.random.default_rng(7 * n + g)
    gids, vals = _ids(kind, n, g, rng), _vals(dtype, n, rng)
    got, _ = model(gids, vals, g, grid=2)
    _assert_sums(got, _reference(gids, vals, g), vals)


# n % 4 in {1, 2, 3} and below one chunk; bases 1-3 rows past a 16-byte
# boundary, the values misaligned differently from the ids or alike
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,id_offset,val_offset", [
    (1, 0, 0), (2, 3, 1), (3, 1, 1), (4_097, 0, 0), (4_098, 0, 0),
    (4_099, 0, 0), (4_099, 1, 2), (4_097, 2, 2), (4_098, 3, 0),
    (4_096, 1, 3)])
def test_model_ragged_and_offset(n, id_offset, val_offset, dtype):
    rng = np.random.default_rng(31 * n + id_offset + 5 * val_offset)
    g = 50
    gids = np.sort(rng.integers(0, g, n)).astype(np.int32)   # all live
    vals = _vals(dtype, n, rng)
    got, trace = model(gids, vals, g, grid=2, id_offset=id_offset,
                       val_offset=val_offset)
    _assert_sums(got, _plain(gids, vals, g), vals)
    _check_costs(gids, g, trace, True)
    # chunk 0 starts id_offset rows before row 0: n + id_offset rows in all
    assert max(trace.live_chunks) == (n + id_offset % 4 - 1) // 4


def test_model_reads_no_value_of_a_dead_chunk():
    """A merge's shape: live ids in the first chunks only; the dead tail's
    chunks load no value, so the values read are those of the live chunks
    alone."""
    n, g = 40_000, 10_000
    gids = np.full(n, g, np.int32)
    gids[:1_001] = np.arange(1_001) * 3
    vals = np.ones(n, np.float32)
    got, trace = model(gids, vals, g, grid=7)
    _assert_sums(got, _plain(gids, vals, g), vals)
    assert sorted(trace.value_chunks) == list(range(-(-1_001 // 4)))


def test_model_adds_a_sorted_run_once_per_range():
    """A sorted run across steps, ranges and dead rows costs one add a
    range that holds it: G = 3 over 20 tiles on 2 CTAs (16 warps, so
    ranges of 8 steps dealt in turn), dead rows between."""
    n, g = 20 * TILE, 3
    gids = np.repeat(np.arange(g + 1, dtype=np.int32), -(-n // (g + 1)))[:n]
    rng = np.random.default_rng(5)
    gids = np.where(rng.random(n) < 0.3, -1, gids).astype(np.int32)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    got, trace = model(gids, vals, g, grid=2)
    _assert_sums(got, _plain(gids, vals, g), vals)
    rows = 32 * CHUNK * RANGE_STEPS
    want = sorted({(r // rows, int(gids[r])) for r in range(n)
                   if 0 <= gids[r] < g})
    assert sorted((k, key) for w, k, key, _ in trace.adds
                  if w == "fold") == want


def test_model_empty_inputs():
    for n, g in ((0, 8), (8, 0)):
        gids = np.zeros(n, np.int32)
        got, trace = model(gids, np.ones(n, np.float32), g, grid=4)
        assert got.shape == (g,) and not trace.adds
