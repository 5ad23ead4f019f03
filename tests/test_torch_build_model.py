"""A numpy model of the CUDA ``build_table`` (``csrc/hash_table.cu``),
step for step, held bit for bit against the reference's jnp
``build_table`` and the port's ``build_table_plain``.

The kernel builds the reference's round-synchronous linear-probing table
in a fixed number of passes. The rows of one home slot move in lock-step
(in round ``i`` every unplaced row of home ``h`` bids for slot ``h + i``),
so one group bids for a slot in a round and the nearest group bids first.
The model follows the kernel's passes:

1. compact the valid rows in row order and hash their homes;
2. sort them by home, stably, by an LSD radix sort of 8-bit digits;
3. a prefix minimum of ``D_i = i - home_i`` over the sorted positions,
   which gives each group's incoming ghost-free stack level on the
   second lap of the cyclic table; a group whose level is 0 starts a
   cluster;
4. each cluster walks its slots with a stack of groups: the top group
   pops its lowest row into the slot, and after a row whose key equals
   ``empty_key`` (a "ghost", which leaves the slot looking empty) the next
   group below pops into the same slot.

The model lives here, not in the package: the package's plain version is
the reference's rounds, and the kernel is the model's only other copy.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import hash_probe as hp  # noqa: E402

# the module (``repro.kernels`` re-exports a function of the same name)
ref_hp = importlib.import_module("repro.kernels.hash_probe")


def _home(keys, t):
    x = keys.astype(np.int64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    return x & (t - 1)


def _radix_sort(homes, rows, bits):
    """Stable LSD radix sort of (home, row) by home, 8 bits a pass, as the
    kernel's passes scatter: a digit's rows keep their order."""
    for shift in range(0, bits, 8):
        digit = (homes >> shift) & 0xFF
        order = np.concatenate([np.flatnonzero(digit == d)
                                for d in range(256)])
        homes, rows = homes[order], rows[order]
    return homes, rows


def model_build(keys, vals, t, empty_key=-1, valid=None):
    """The kernel's build of ``t`` slots (``len(keys) < t``)."""
    n = len(keys)
    assert n < t and t & (t - 1) == 0
    tk = np.full(t, empty_key, np.int32)
    tv = np.zeros(t, np.int32)
    rows = np.arange(n) if valid is None else np.flatnonzero(valid)
    m = len(rows)
    if m == 0:
        return tk, tv
    homes, rows = _radix_sort(_home(keys[rows], t), rows,
                              max(1, int(t).bit_length() - 1))
    assert np.all(np.diff(homes) >= 0)
    skey, sval = keys[rows], vals[rows]
    # 3. exclusive prefix minimum of D, the total minimum, the level at the
    # end of the first lap
    d = np.arange(m) - homes
    excl = np.minimum.accumulate(np.concatenate([[np.iinfo(np.int64).max],
                                                 d[:-1]]))
    gmin = int(d.min())
    l_end = (m - t) - min(0, gmin, m - t)
    head = np.ones(m, bool)
    head[1:] = homes[1:] != homes[:-1]
    starts = np.flatnonzero(head & (d <= np.minimum(-l_end, excl)))
    assert len(starts) >= 1   # m < t leaves a cut
    for p in starts:
        _resolve(p, homes, skey, sval, m, t, empty_key, tk, tv)
    return tk, tv


def _resolve(p, homes, skey, sval, m, t, empty_key, tk, tv):
    """One cluster from its first group at sorted position ``p``: the
    kernel's thread, with the stack as a list of group cursors."""
    stack = []          # the next row of each group, bottom first
    s = int(homes[p])   # the slot, unwrapped
    q, lap = p, 0       # the next group to push; T once q has wrapped
    level = 0           # the ghost-free level
    while True:
        pushed = 0
        if int(homes[q]) + lap == s:
            stack.append(q)
            h = homes[q]
            while q < m and homes[q] == h:
                q += 1
                pushed += 1
            if q == m:
                q, lap = 0, t
        k = len(stack) - 1
        while k >= 0:
            r = stack[k]
            tk[s & (t - 1)] = skey[r]
            tv[s & (t - 1)] = sval[r]
            done = r + 1 == m or homes[r + 1] != homes[r]
            stack[k] = -1 if done else r + 1
            if skey[r] != empty_key:
                break
            k -= 1
        stack = [c for c in stack if c >= 0]
        level = max(0, level + pushed - 1)
        if level == 0:
            assert not stack
            return
        s += 1
        if not stack:
            gap = int(homes[q]) + lap - s
            if gap >= level:
                return
            level -= gap
            s += gap


def _case(kind, t, n, rng):
    """(keys, vals, valid) for a sweep case of ``n < t`` rows."""
    vals = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    valid = None
    if kind == "unique":
        keys = rng.permutation(10 * t)[:n].astype(np.int32)
    elif kind == "duplicates":
        keys = rng.integers(0, max(1, n // 8), n).astype(np.int32)
    elif kind == "invalid_and_minus_one":
        keys = rng.integers(-3, max(2, n // 2), n).astype(np.int32)
        valid = rng.random(n) < 0.7
    elif kind == "ghosts":      # most keys equal empty_key
        keys = np.where(rng.random(n) < 0.7, -1,
                        rng.integers(0, 5, n)).astype(np.int32)
    else:                       # homes forced near the table's end
        pool = np.arange(-(1 << 20), 1 << 20, dtype=np.int32)
        near = pool[_home(pool, t) >= t - max(2, t // 16)]
        keys = rng.choice(near, n).astype(np.int32)
        valid = rng.random(n) < 0.9
    return keys, vals, valid


_KINDS = ("unique", "duplicates", "invalid_and_minus_one", "ghosts",
          "wrap")
_SWEEP = [(kind, t, seed) for kind in _KINDS for t in (4, 16, 64, 256, 1024)
          for seed in range(3)]


@pytest.mark.parametrize("kind,t,seed", _SWEEP)
def test_model_equals_reference_and_plain(kind, t, seed):
    rng = np.random.default_rng(1000 * t + 10 * seed + _KINDS.index(kind))
    for n in sorted({0, 1, t // 4, t // 2, t - 1,
                     int(rng.integers(0, t))}):
        keys, vals, valid = _case(kind, t, n, rng)
        got = model_build(keys, vals, t, -1, valid)
        ref = ref_hp.build_table(jnp.asarray(keys), jnp.asarray(vals), t, -1,
                                 None if valid is None else jnp.asarray(valid))
        plain = hp.build_table_plain(
            torch.from_numpy(keys), torch.from_numpy(vals), t, -1,
            None if valid is None else torch.from_numpy(valid))
        for g, r, p in zip(got, ref, plain):
            np.testing.assert_array_equal(g, np.asarray(r), err_msg=str(n))
            np.testing.assert_array_equal(g, p.numpy(), err_msg=str(n))


@pytest.mark.parametrize("case", ["one_home_1000_rows", "all_ghost_cluster",
                                  "ghosts_over_a_run",
                                  "wrap_through_last_slot", "empty_key_7"])
def test_model_edge_cases(case):
    """The card's edge cases of ``build_table`` (``chip_smoke.py`` phase 3),
    at the sizes the card runs them."""
    rng = np.random.default_rng(len(case))
    t, empty = 4096, -1
    if case == "one_home_1000_rows":
        keys = np.full(1000, 12345, np.int32)
    elif case == "all_ghost_cluster":
        keys = np.concatenate([np.full(40, -1), rng.integers(0, 1 << 20, 500)])
        keys = rng.permutation(keys).astype(np.int32)
    elif case == "ghosts_over_a_run":
        # 30 ghosts whose home lies inside the run of a key of 200 rows:
        # the run's rows pop into the slots the ghosts leave empty
        pool = np.arange(1 << 20, dtype=np.int32)
        ghost = int(_home(np.array([-1], np.int32), t)[0])
        run = pool[_home(pool, t) == (ghost - 20) % t][0]
        keys = np.concatenate([np.full(200, run), np.full(30, -1),
                               rng.permutation(1 << 22)[:770] + (1 << 20)])
        keys = rng.permutation(keys).astype(np.int32)
    elif case == "wrap_through_last_slot":
        pool = np.arange(1 << 20, dtype=np.int32)
        keys = rng.choice(pool[_home(pool, t) >= t - 8], 300).astype(np.int32)
    else:   # another empty key: rows of key 7 are ghosts, -1 is a key
        empty = 7
        keys = rng.integers(-1, 9, 1500).astype(np.int32)
    vals = np.arange(len(keys), dtype=np.int32)
    got = model_build(keys, vals, t, empty)
    ref = ref_hp.build_table(jnp.asarray(keys), jnp.asarray(vals), t, empty)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
