"""The segmented sums' partition (``csrc/segmented_agg.cu``,
``segmented_sum_kernel``) as a numpy model on the CPU, against the plain
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

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import segmented_agg as ref_seg
from repro_torch.kernels import segmented_agg as seg

SOURCE = (Path(seg.__file__).resolve().parent / "csrc"
          / "segmented_agg.cu").read_text()


def _const(name, **earlier):
    """A ``constexpr int`` of the source, in C's integer arithmetic over the
    constants ``earlier`` names."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    return eval(m.group(1).replace("/", "//"), earlier)  # noqa: S307


THREADS = _const("kThreads")
CHUNK = _const("kChunkRows")
WARPS = _const("kWarps", kThreads=THREADS)
STEPS_AHEAD = _const("kStepsAhead")
RANGE_STEPS = _const("kRangeSteps")
SHARED_GROUPS = _const("kSharedGroups")
TILE = THREADS * CHUNK


class Trace:
    """What a model run did: the adds (("fold" for a run's add, "flush"
    for a shared partial's; the range, or the CTA for a flush; the group;
    the sum)), the chunks whose values were loaded, and the chunks with a
    live id."""

    def __init__(self):
        self.adds = []
        self.value_chunks = []
        self.live_chunks = []


def _shfl_up(x, d):
    return [x[i - d] if i >= d else x[i] for i in range(32)]


def _warp_sum(xs, acc):
    """``warp_sum``: the xor butterfly for floats, a plain wrapping sum
    (``__reduce_add_sync``) for ints."""
    if acc is np.uint32:
        return acc(sum(int(x) for x in xs) & 0xFFFFFFFF)
    xs = list(xs)
    for off in (16, 8, 4, 2, 1):
        xs = [acc(xs[i] + xs[i ^ off]) for i in range(32)]
    return xs[0]


def _add(a, b, acc):
    if acc is np.uint32:
        return acc((int(a) + int(b)) & 0xFFFFFFFF)
    return acc(a + b)


def fold_chunk(g, v, acc, add):
    """``fold_chunk``: (have, [fk, fs, lk, ls, one])."""
    have, fk, lk, fs, ls, one = False, -1, -1, acc(0), acc(0), True
    for k in range(CHUNK):
        if g[k] < 0:
            continue
        if not have:
            have, fk, lk, ls = True, g[k], g[k], v[k]
        elif g[k] == lk:
            ls = _add(ls, v[k], acc)
        else:
            if one:
                fs, one = ls, False
            else:
                add(lk, ls)
            lk, ls = g[k], v[k]
    if one:
        fs = ls
    return have, [fk, fs, lk, ls, one]


def fold_warp(have, lanes, acc, add):
    """``fold_warp`` over 32 lanes' runs ([fk, fs, lk, ls, one] each):
    None when no lane has a live row, else the joined [fk, fs, lk, ls,
    one]."""
    live = [i for i in range(32) if have[i]]
    if not live:
        return None
    fk, fs, lk, ls, one = (list(x) for x in zip(*lanes))
    if len(live) < 32:
        src = {i: (lk[max(j for j in live if j < i)] if any(j < i for j in live)
                   else fk[min(j for j in live if j > i)])
               for i in range(32) if not have[i]}
        for i, k in src.items():
            fk[i] = lk[i] = k
            fs[i] = ls[i] = acc(0)
            one[i] = True
    k0 = fk[0]
    if all(one[i] and fk[i] == k0 for i in range(32)):
        s = _warp_sum(ls, acc)
        return [k0, s, k0, s, True]
    prev_lk = _shfl_up(lk, 1)
    next_fk = fk[1:] + [fk[31]]
    joins = [i > 0 and prev_lk[i] == fk[i] for i in range(32)]
    heads = [not (joins[i] and one[i]) for i in range(32)]
    start = [max(j for j in range(i + 1) if heads[j]) for i in range(32)]
    s = list(ls)
    for off in (1, 2, 4, 8, 16):
        o = _shfl_up(s, off)
        s = [_add(s[i], o[i], acc) if i - off >= start[i] else s[i]
             for i in range(32)]
    s_prev, start_prev, one0 = _shfl_up(s, 1), _shfl_up(start, 1), one[0]
    ends = [i == 31 or next_fk[i] != lk[i] for i in range(32)]
    holders = []
    for i in range(32):
        if not one[i]:
            e = _add(fs[i], s_prev[i], acc) if joins[i] else fs[i]
            if i == 0 or (joins[i] and start_prev[i] == 0 and one0):
                holders.append((i, e))
            else:
                add(fk[i], e)
            if i != 31 and ends[i]:
                add(lk[i], s[i])
        elif ends[i]:
            if start[i] == 0 and one0:
                holders.append((i, s[i]))
            elif i != 31:
                add(lk[i], s[i])
    assert len(holders) == 1, holders
    i, first = holders[0]
    assert i != 31 or not one[31]
    return [fk[i], first, lk[31], s[31], False]


def join_runs(state, nxt, acc, add):
    """``join_runs``: ``state`` = [open, [fk, fs, lk, ls, one]] followed by
    the runs ``nxt``."""
    if not state[0]:
        state[:] = [True, list(nxt)]
        return
    a = state[1]
    afk, afs, alk, als, aone = a
    nfk, nfs, nlk, nls, none = nxt
    if alk == nfk:
        joined = _add(als, nfs, acc)
        if aone and none:
            a[1] = a[3] = joined
        elif aone:
            a[:] = [afk, joined, nlk, nls, False]
        elif none:
            a[3] = joined
        else:
            add(alk, joined)
            a[2], a[3] = nlk, nls
    else:
        if not aone:
            add(alk, als)
        if not none:
            add(nfk, nfs)
        a[2], a[3], a[4] = nlk, nls, False


def _model_range(gids, vals, num_groups, n, a, vec, s_begin, s_end, acc,
                 trace, k, dest):
    """One warp's range of steps: its adds go to ``dest`` (the CTA's shared
    partials, or the output)."""
    def add(key, s):
        assert 0 <= key < num_groups
        trace.adds.append(("fold", k, key, s))
        dest[key] = _add(dest[key], s, acc)

    state = [False, [-1, acc(0), -1, acc(0), True]]
    for st in range(s_begin, s_end, STEPS_AHEAD):
        loaded = []
        for u in range(STEPS_AHEAD):
            step = []
            for lane in range(32):
                r0 = ((st + u) * 32 + lane) * CHUNK - a
                g = [int(gids[r]) if st + u < s_end and 0 <= r < n else -1
                     for r in range(r0, r0 + CHUNK)]
                step.append((r0, [x if 0 <= x < num_groups else -1
                                  for x in g]))
            loaded.append(step)
        if all(x < 0 for step in loaded for _, g in step for x in g):
            continue        # no live id in the warp's steps
        values = []
        for u, step in enumerate(loaded):
            vs = []
            for lane, (r0, g) in enumerate(step):
                v = [acc(0)] * CHUNK
                if any(x >= 0 for x in g):
                    chunk = (st + u) * 32 + lane
                    trace.live_chunks.append(chunk)
                    trace.value_chunks.append(chunk)
                    full = vec and r0 >= 0 and r0 + CHUNK <= n
                    v = [vals[r0 + j] if (full or g[j] >= 0) else acc(0)
                         for j in range(CHUNK)]
                vs.append(v)
            values.append(vs)
        for u in range(STEPS_AHEAD):
            have, lanes = [], []
            for lane in range(32):
                h, r = fold_chunk(loaded[u][lane][1], values[u][lane], acc,
                                  add)
                have.append(h)
                lanes.append(r)
            w = fold_warp(have, lanes, acc, add)
            if w is not None:
                join_runs(state, w, acc, add)
    if state[0]:
        fk, fs, lk, ls, one = state[1]
        add(fk, fs)
        if not one:
            add(lk, ls)


def model(gids, vals, num_groups, grid, id_offset=0, val_offset=0):
    """One launch of ``segmented_sum_kernel`` on ``grid`` CTAs (the launch
    takes min(resident CTAs, tiles)), with the ids' base ``id_offset`` and
    the values' ``val_offset`` rows past a 16-byte boundary: (out, Trace)."""
    acc = np.uint32 if vals.dtype == np.int32 else np.float32
    vals = vals.view(np.uint32) if acc is np.uint32 else vals
    n = len(gids)
    out = np.zeros(num_groups, acc)
    trace = Trace()
    if n == 0 or num_groups == 0:
        return out.view(np.int32) if acc is np.uint32 else out, trace
    a = id_offset % CHUNK
    vec = val_offset % CHUNK == a
    chunks = -(-(n + a) // CHUNK)
    steps = -(-chunks // 32)
    grid = min(grid, -(-chunks // THREADS))
    warps = grid * WARPS
    rng = -(-steps // warps)
    rng = min(-(-rng // STEPS_AHEAD) * STEPS_AHEAD, RANGE_STEPS)
    shared = num_groups <= SHARED_GROUPS
    for b in range(grid):
        part = np.zeros(num_groups, acc) if shared else None
        for warp in range(WARPS):
            k = b * WARPS + warp
            while k * rng < steps:
                _model_range(gids, vals, num_groups, n, a, vec, k * rng,
                             min((k + 1) * rng, steps), acc, trace, k,
                             part if shared else out)
                k += warps
        if shared:
            for g in np.nonzero(part)[0]:
                trace.adds.append(("flush", b, int(g), part[g]))
                out[g] = _add(out[g], part[g], acc)
    return (out.view(np.int32) if acc is np.uint32 else out), trace


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
