"""The port's expansion probe (``repro_torch.kernels.hash_probe``
``hash_probe_multi``) and a numpy model of its kernel's row store, the
expansion join built on it, the expressions the
remaining TPC-H queries add (``BytesMatch``, ``Year``, ``PrefixCode``) and
the fused kernel's ``PrefixCode`` lowering, against the reference, on
inputs made from a seed with numpy.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernel is
checked by ``test_torch_gpu.py`` (skipped without a card) and by
``chip_smoke.py``. The probe is exact by contract: counts and every slot
under the count mask must equal the reference's Pallas kernel in
interpret mode. The fused program runs through ``torch_diff.emulate``,
which follows the CUDA kernel's 32-bit semantics.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import (assert_tables_equal, emulate, port_schema,  # noqa: E402
                        to_port)

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import fused as ref_fused  # noqa: E402
from repro.core import operators as ref_ops  # noqa: E402
from repro.core.expr import col, lit, prefix_code, year  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ops as ref_kernel_ops  # noqa: E402
from repro_torch.core import fused  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import hash_probe as hp  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402

# the module (``repro.kernels`` re-exports a function of the same name)
ref_hp = importlib.import_module("repro.kernels.hash_probe")


# ---------------------------------------------------------------------------
# hash_probe_multi
# ---------------------------------------------------------------------------

def _dup_table(case, seed):
    """(build keys, valid, table size): runs of equal keys, up to 6 a key
    (more than the match capacity), invalid rows and a -1 key."""
    rng = np.random.default_rng(seed)
    if case == "few_duplicates":
        keys = rng.integers(0, 400, 500).astype(np.int32)
        return keys, rng.random(500) < 0.9, 2048
    if case == "long_runs":
        keys = np.repeat(rng.permutation(1000)[:100], 6).astype(np.int32)
        rng.shuffle(keys)
        keys[:3] = -1
        return keys, rng.random(600) < 0.95, 2048
    if case == "unique":
        keys = rng.permutation(10_000)[:700].astype(np.int32)
        return keys, np.ones(700, bool), 2048
    raise AssertionError(case)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("case", ["few_duplicates", "long_runs", "unique"])
def test_hash_probe_multi_matches_reference(case, m):
    keys, valid, t = _dup_table(case, seed=len(case))
    tk, tv = ref_hp.build_table(jnp.asarray(keys),
                                jnp.arange(len(keys), dtype=jnp.int32), t,
                                empty_key=-1, valid=jnp.asarray(valid))
    tk, tv = np.array(tk), np.array(tv)
    max_probes = ref_ops._probe_bound(tk)
    rng = np.random.default_rng(m)
    probe = rng.choice(keys, 1500).astype(np.int32)
    probe[rng.random(1500) < 0.2] = 77_777          # absent
    probe[:7] = -1
    want_c, want_s = ref_hp.hash_probe_multi(
        jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(probe), m,
        empty_key=-1, max_probes=max_probes, interpret=True)
    want_c, want_s = np.asarray(want_c), np.asarray(want_s)
    count, slots = hp.hash_probe_multi(torch.from_numpy(tk),
                                       torch.from_numpy(tv),
                                       torch.from_numpy(probe), m,
                                       empty_key=-1, max_probes=max_probes)
    assert count.dtype == torch.int32 and slots.shape == (1500, m)
    np.testing.assert_array_equal(count.numpy(), want_c)
    live = np.arange(m)[None, :] < want_c[:, None]
    np.testing.assert_array_equal(slots.numpy()[live], want_s[live])
    # past the count the kernel's contract is 0: a gather stays in bounds
    assert not slots.numpy()[~live].any()
    if case == "long_runs":
        assert (want_c == min(m, 6)).any()          # capacity reached


def test_expansion_matches_are_in_build_row_order():
    keys = np.array([5, 9, 5, 5, 9, 5, 5], np.int32)
    tk, tv = hp.build_table(torch.from_numpy(keys),
                            torch.arange(7, dtype=torch.int32), 16)
    count, slots = hp.hash_probe_multi(tk, tv, torch.tensor([5, 9, 4],
                                                            dtype=torch.int32),
                                       4, max_probes=16)
    assert count.tolist() == [4, 2, 0]
    assert slots.tolist() == [[0, 2, 3, 5], [1, 4, 0, 0], [0, 0, 0, 0]]


def test_cpu_expansion_probe_marks_probe_and_launches_nothing():
    kernel_ops.reset_launch_counts()
    used = set()
    tk = torch.full((8,), -1, dtype=torch.int32)
    with kernel_ops.record_kernels(used):
        hp.hash_probe_multi(tk, torch.zeros(8, dtype=torch.int32),
                            torch.arange(5, dtype=torch.int32), 4)
    assert used == {"probe"}
    assert all(v == 0 for v in kernel_ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the kernel's row store, as a numpy model
# ---------------------------------------------------------------------------

_TABLE_SOURCE = (Path(hp.__file__).resolve().parent / "csrc"
                 / "hash_table.cu").read_text()
_THREADS = int(re.search(r"constexpr int kThreads = (\d+);",
                         _TABLE_SOURCE).group(1))
_MAX_STAGED = eval(re.search(  # noqa: S307
    r"constexpr size_t kMaxStagedBytes = ([^;]+);", _TABLE_SOURCE).group(1))
_POISON = np.int32(0x5A5A5A5A)


def _homes(keys, t):
    x = keys.astype(np.int32).view(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x.astype(np.uint64) * np.uint64(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    return (x & np.uint32(t - 1)).astype(np.int64)


def _walk(tk, tv, key, home, max_probes, empty_key, m):
    """``probe_multi``'s walk of one key: its matches in run order."""
    t, out = len(tk), []
    for i in range(min(max_probes, t)):
        if len(out) >= m:
            break
        s = (home + i) & (t - 1)
        if tk[s] == key:
            out.append(int(tv[s]))
        if tk[s] == empty_key:
            break
    return out


def _walk_groups(tk, tv, key, home, max_probes, empty_key, m):
    """``probe_multi_row``'s walk of one key: the run read a 16-byte group
    of 4 slots at a time from the group that holds the home slot, the
    slots before the home skipped; its matches in run order."""
    t, out = len(tk), []
    i, go = 0, min(max_probes, t) > 0
    while go:
        s = (home + i) & (t - 1)
        base = s & ~3
        for j in range(4):
            if go and j >= (s & 3):
                k = tk[base + j]
                if k == key:
                    out.append(int(tv[base + j]))
                i += 1
                go = k != empty_key and i < min(max_probes, t) and len(out) < m
    return out


def multi_model(tk, tv, keys, m, max_probes, empty_key=-1, slots_addr=0,
                tk_addr=0):
    """``hash_table_probe_multi`` on numpy arrays, onto a count and slots
    that hold ``_POISON`` first, the route chosen as the entry chooses it
    (``slots_addr`` the slots' address, ``tk_addr`` the table keys'):
    (count, slots, route). "row": m of 2, 4, 8 with rows aligned for one
    store of min(4 m, 16) bytes and a table of 4 slots or more on a 16-byte
    boundary, the run walked in groups of 4 slots and the row (matches,
    then zeros) stored whole; "staged": a CTA's rows written into a tile of
    shared memory (matches, then zeros), the tile's words stored in order;
    "slots": a store a slot, the matches, then zeros."""
    n = len(keys)
    count = np.full(n, _POISON, np.int32)
    slots = np.full((n, m), _POISON, np.int32)
    aligned = slots_addr % min(4 * m, 16) == 0
    if (aligned and m in (2, 4, 8) and len(tk) >= 4
            and tk_addr % 16 == 0):
        route = "row"
    elif _THREADS * m * 4 <= _MAX_STAGED:
        route = "staged"
    else:
        route = "slots"
    home = _homes(keys, len(tk))
    walk = _walk_groups if route == "row" else _walk
    rows = [walk(tk, tv, keys[i], home[i], max_probes, empty_key, m)
            for i in range(n)]
    flat = slots.reshape(-1)
    if route == "staged":
        for base in range(0, n, _THREADS):
            tile = np.full(_THREADS * m, _POISON, np.int32)
            for j, row in enumerate(rows[base:base + _THREADS]):
                tile[j * m:(j + 1) * m] = row + [0] * (m - len(row))
                count[base + j] = len(row)
            words = min(_THREADS, n - base) * m
            flat[base * m:base * m + words] = tile[:words]
    else:
        for i, row in enumerate(rows):
            slots[i] = row + [0] * (m - len(row))
            count[i] = len(row)
    return count, slots, route


def _model_table(case, seed):
    """(table keys, table values, probe keys, max_probes) of a model case:
    "duplicates" (up to 12 rows a key, past m; hits, misses, -1),
    "wrapping" (a 64-slot table 80% full whose runs wrap at T),
    "cut" (a full run cut by max_probes 3), "empty_key" (every probe key
    -1)."""
    rng = np.random.default_rng(seed)
    nb, pool, t, probe_hi = {"duplicates": (700, 120, 2048, 160),
                             "wrapping": (51, 30, 64, 40),
                             "cut": (900, 200, 1024, 260),
                             "empty_key": (100, 50, 256, 0)}[case]
    while True:
        bk = rng.integers(-1 if case in ("duplicates", "wrapping") else 0,
                          pool, nb).astype(np.int32)
        tk, tv = ref_hp.build_table(jnp.asarray(bk),
                                    jnp.arange(nb, dtype=jnp.int32), t,
                                    empty_key=-1)
        tk, tv = np.array(tk), np.array(tv)
        # the wrapping case's table has a run across slot 0
        if case != "wrapping" or (tk[0] != -1 and tk[-1] != -1):
            break
    probe = (rng.integers(-1, probe_hi, 1500).astype(np.int32) if probe_hi
             else np.full(1500, -1, np.int32))
    mp = 3 if case == "cut" else ref_ops._probe_bound(tk)
    return tk, tv, probe, mp


@pytest.mark.parametrize("m", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("case", ["duplicates", "wrapping", "cut",
                                  "empty_key"])
def test_row_store_model_matches_reference(case, m):
    tk, tv, probe, mp = _model_table(case, seed=len(case) + m)
    count, slots, route = multi_model(tk, tv, probe, m, mp)
    assert route == ("row" if m in (4, 8) else "staged")
    want_c, want_s = ref_hp.hash_probe_multi(
        jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(probe), m,
        empty_key=-1, max_probes=mp, interpret=True)
    want_c, want_s = np.asarray(want_c), np.asarray(want_s)
    np.testing.assert_array_equal(count, want_c)
    live = np.arange(m)[None, :] < want_c[:, None]
    np.testing.assert_array_equal(slots[live], want_s[live])
    # every slot past the count is written, with 0
    assert (slots[~live] == 0).all()
    if case == "duplicates":
        assert (count == m).any() and (count == 0).any()
    if case == "empty_key":
        assert (count == 1).all()          # the first empty slot, a match
    # the plain version agrees, zeros included
    pc, ps = hp.hash_probe_multi_plain(torch.from_numpy(tk),
                                       torch.from_numpy(tv),
                                       torch.from_numpy(probe), m, -1, mp)
    np.testing.assert_array_equal(pc.numpy(), count)
    np.testing.assert_array_equal(ps.numpy(), slots)


@pytest.mark.parametrize("m,addr,route", [
    (4, 0, "row"), (4, 8, "staged"), (2, 4, "staged"), (8, 16, "row"),
    (3, 0, "staged"), (_MAX_STAGED // (4 * _THREADS), 0, "staged"),
    (_MAX_STAGED // (4 * _THREADS) + 1, 0, "slots")])
def test_row_store_routes(m, addr, route):
    """Each route writes the same rows: a misaligned base leaves the
    whole-row store for the staged one; rows past a CTA's shared memory
    take a store a slot."""
    tk, tv, probe, mp = _model_table("duplicates", seed=m)
    probe = probe[:300]
    count, slots, got = multi_model(tk, tv, probe, m, mp, slots_addr=addr)
    assert got == route
    pc, ps = hp.hash_probe_multi_plain(torch.from_numpy(tk),
                                       torch.from_numpy(tv),
                                       torch.from_numpy(probe), m, -1, mp)
    np.testing.assert_array_equal(pc.numpy(), count)
    np.testing.assert_array_equal(ps.numpy(), slots)


@pytest.mark.parametrize("t,tk_addr,route", [
    (1, 0, "staged"), (2, 0, "staged"), (4, 0, "row"), (8, 0, "row"),
    (64, 4, "staged"), (64, 0, "row")])
def test_group_walk_route_needs_the_table(t, tk_addr, route):
    """The group walk takes a table of 4 slots or more on a 16-byte
    boundary; a smaller table or one off its boundary stages its rows.
    Either walk gives the plain version's rows, runs that wrap at T and
    max_probes cut short included."""
    rng = np.random.default_rng(t + tk_addr)
    bk = rng.integers(-1, max(t // 2, 2), max(t - 1, 0)).astype(np.int32)
    tk, tv = ref_hp.build_table(jnp.asarray(bk),
                                jnp.arange(len(bk), dtype=jnp.int32), t,
                                empty_key=-1)
    tk, tv = np.array(tk), np.array(tv)
    probe = rng.integers(-1, max(t // 2, 2) + 2, 400).astype(np.int32)
    for mp in range(1, t + 1):
        count, slots, got = multi_model(tk, tv, probe, 4, mp,
                                        tk_addr=tk_addr)
        assert got == route
        pc, ps = hp.hash_probe_multi_plain(torch.from_numpy(tk),
                                           torch.from_numpy(tv),
                                           torch.from_numpy(probe), 4, -1, mp)
        np.testing.assert_array_equal(pc.numpy(), count)
        np.testing.assert_array_equal(ps.numpy(), slots)


# ---------------------------------------------------------------------------
# the expansion join
# ---------------------------------------------------------------------------

_BUILD_SCHEMA = {"k": rdt.INT32, "k2": rdt.DATE32, "pi": rdt.INT32,
                 "pf": rdt.FLOAT32, "ps": rdt.bytes_(3)}
_PROBE_SCHEMA = {"k": rdt.INT32, "k2": rdt.DATE32, "v": rdt.FLOAT32}


def _sides(seed):
    """A build side with up to 5 rows a key (beyond max_matches=4 for
    some), and probe batches with hits, misses and -1 keys."""
    rng = np.random.default_rng(seed)
    nb, np_ = 800, 1500
    bk = rng.integers(0, 250, nb).astype(np.int32)
    build = {"k": bk, "k2": rng.integers(9000, 9004, nb).astype(np.int32),
             "pi": rng.integers(-50, 50, nb).astype(np.int32),
             "pf": rng.normal(size=nb).astype(np.float32),
             "ps": rng.integers(0, 255, (nb, 3)).astype(np.uint8)}
    pk = rng.integers(0, 300, np_).astype(np.int32)
    pk[:4] = -1
    probe = {"k": pk, "k2": rng.integers(8999, 9005, np_).astype(np.int32),
             "v": rng.normal(size=np_).astype(np.float32)}
    return build, rng.random(nb) < 0.9, probe, rng.random(np_) < 0.9


def _both(data, schema, valid, capacity):
    pad = np.pad(valid, (0, capacity - len(valid)))
    ref = DeviceTable.from_numpy(data, schema, capacity=capacity)
    port = TorchTable.from_numpy(data, port_schema(schema), capacity=capacity,
                                 device="cpu")
    return (ref.filter(jnp.asarray(pad)),
            port.filter(torch.from_numpy(pad)))


@pytest.mark.parametrize("keys", [("k",), ("k", "k2")])
@pytest.mark.parametrize("join_type", ["inner", "left_outer"])
def test_expansion_join_matches_reference_operator(join_type, keys):
    build, bvalid, probe, pvalid = _sides(seed=len(join_type) + len(keys))
    rb, pb = _both(build, _BUILD_SCHEMA, bvalid, 1024)
    payload = ("pi", "pf", "ps")
    with ref_kernel_ops.use_backend("pallas"):
        want_op = ref_ops.HashJoin(keys, keys, payload, join_type=join_type,
                                   max_matches=4, build_rows=800)
        want_op.open()
        want_op.add_build(rb)
        want_op.seal_build()
        assert want_op._multi
        outs = []
        for lo in (0, 1000):                  # two probe batches
            rp, pp = _both({c: v[lo:lo + 1000] for c, v in probe.items()},
                           _PROBE_SCHEMA, pvalid[lo:lo + 1000], 1000)
            outs.append((want_op.add_input(rp)[0], pp))
    got_op = ops.HashJoin(keys, keys, payload, join_type, max_matches=4,
                          build_rows=800)
    got_op.open()
    got_op.add_build(pb)
    got_op.seal_build()
    assert got_op._multi and got_op._pack == want_op._pack
    for want, pp in outs:
        used = {}
        with kernel_ops.collect_dispatches(used):
            (got,) = got_op.add_input(pp)
        # the expansion probe, then the compaction of its P x m rows
        assert used == {"probe": 1, "compact": 1}
        assert got.capacity == want.capacity
        assert sorted(got.column_names) == sorted(want.column_names)
        want_valid = np.asarray(want.validity)
        np.testing.assert_array_equal(got.validity.numpy(), want_valid)
        n = int(want_valid.sum())
        assert n > 0
        for name in want.column_names:
            np.testing.assert_array_equal(got.columns[name].numpy()[:n],
                                          np.asarray(want.columns[name])[:n],
                                          err_msg=name)
            assert got.schema[name] == to_port(want.schema[name]), name


def test_expansion_join_is_not_fused_into_the_scan():
    build, bvalid, _, _ = _sides(seed=1)
    _, pb = _both(build, _BUILD_SCHEMA, bvalid, 1024)
    join = ops.HashJoin(("k",), ("k",), ("pi",), max_matches=4)
    join.add_build(pb)
    join.seal_build()
    pipe = ops.Pipeline([ops.FilterProject(to_port(col("v") > lit(0.0))),
                         join])
    ops.fuse_morsel_pipeline(pipe)
    assert [type(op).__name__ for op in pipe.ops] == ["FilterProject",
                                                      "HashJoin"]


# ---------------------------------------------------------------------------
# BytesMatch, Year, PrefixCode
# ---------------------------------------------------------------------------

_WORDS = [b"green", b"special", b"requests", b"forest", b"Customer",
          b"Complaints", b"BRASS", b"xx", b"gree"]


def _text_table(n, width, seed):
    """Space-padded rows of words (some rows full width, some empty)."""
    rng = np.random.default_rng(seed)
    rows = np.full((n, width), ord(" "), np.uint8)
    for i in range(n):
        text = b" ".join(rng.choice(_WORDS, rng.integers(0, 5)))[:width]
        if i % 17 == 0:
            text = (b"Customer" * 8)[:width]
        rows[i, :len(text)] = np.frombuffer(text, np.uint8)
    phone = rng.integers(ord("0"), ord("9") + 1, (n, 15)).astype(np.uint8)
    days = rng.integers(-800, 26_000, n).astype(np.int32)
    days[:4] = [-1, 0, 25_567, 25_568]          # 1969, 1970, 2039, 2040
    data = {"s": rows, "p": phone, "d": days}
    schema = {"s": rdt.bytes_(width), "p": rdt.bytes_(15), "d": rdt.DATE32}
    return (DeviceTable.from_numpy(data, schema),
            TorchTable.from_numpy(data, port_schema(schema), device="cpu"))


_EXPRS = {
    "contains_one": lambda: col("s").contains("green"),
    "contains_ordered": lambda: col("s").contains("special", "requests"),
    "contains_three": lambda: col("s").contains("Customer", "Comp", "s"),
    "contains_longer_than_row": lambda: col("s").contains("x" * 40),
    "not_contains": lambda: ~col("s").contains("Customer", "Complaints"),
    "startswith": lambda: col("s").startswith("forest"),
    "endswith": lambda: col("s").endswith("BRASS"),
    "endswith_space_padded": lambda: col("s").endswith("s"),
    "year": lambda: year(col("d")),
    "year_arith": lambda: year(col("d")) * lit(2) - lit(3),
    "prefix_code": lambda: prefix_code(col("p"), 2),
    "prefix_code_isin": lambda: prefix_code(col("p"), 2).isin([13, 31, 23]),
}


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_expr_matches_reference(name):
    ref_t, port_t = _text_table(300, 30, seed=len(name))
    e = _EXPRS[name]()
    want = np.asarray(e.evaluate(ref_t))
    pe = to_port(e)
    got = pe.evaluate(port_t).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert pe.out_dtype(port_t.schema) == to_port(e.out_dtype(ref_t.schema))
    assert pe.references() == e.references()


# ---------------------------------------------------------------------------
# the fused kernel's PrefixCode (Q22's stages)
# ---------------------------------------------------------------------------

def _q22_stages():
    cust = (None, (("c_custkey", col("c_custkey")),
                   ("cntrycode", prefix_code(col("c_phone"), 2)),
                   ("c_acctbal", col("c_acctbal"))))
    return [cust, (col("cntrycode").isin([13, 31, 23, 29, 30, 18, 17]),
                   None),
            (col("c_acctbal") > lit(0.0), None)]


def _customers(n, seed):
    rng = np.random.default_rng(seed)
    phone = rng.integers(ord("0"), ord("9") + 1, (n, 15)).astype(np.uint8)
    phone[:, 0] = rng.choice(np.frombuffer(b"123", np.uint8), n)
    data = {"c_custkey": np.arange(n, dtype=np.int32), "c_phone": phone,
            "c_acctbal": rng.normal(0, 500, n).astype(np.float32)}
    schema = {"c_custkey": rdt.INT32, "c_phone": rdt.bytes_(15),
              "c_acctbal": rdt.FLOAT32}
    return data, schema


def test_fused_prefix_code_matches_reference_and_emulator():
    data, schema = _customers(2500, seed=22)
    # capacity not a multiple of the 1024-row block: padded rows are dead
    ref_t = DeviceTable.from_numpy(data, schema, capacity=2600)
    port_t = TorchTable.from_numpy(data, port_schema(schema), capacity=2600,
                                   device="cpu")
    stages = _q22_stages()
    want, _, _ = ref_fused.fused_morsel_program(ref_t, stages, interpret=True)
    pstages = to_port(stages)
    got, _, _ = fused.fused_morsel_program(port_t, pstages)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    assert got.validity.any()
    for name in want.column_names:
        np.testing.assert_array_equal(got.columns[name].numpy(),
                                      np.asarray(want.columns[name]),
                                      err_msg=name)
    program = fused.lower_stages(port_t, pstages)
    assert program.in_widths == (0, 15, 0)
    assert (program.code[:, 0] == fused.OPS["LOADB"]).sum() == 2
    assert_tables_equal(emulate(program, port_t),
                        fused.apply_stages(port_t, pstages))


def test_lowering_refuses_bytes_it_cannot_read():
    data, schema = _customers(16, seed=1)
    t = TorchTable.from_numpy(data, port_schema(schema), device="cpu")
    with pytest.raises(NotImplementedError):         # past the row width
        fused.lower_stages(t, [(None, (("x", to_port(
            prefix_code(col("c_phone"), 16))),))])
    # a LIKE and an EXTRACT(YEAR) lower to BYTESMATCH and YEAR (they once
    # raised here) and run in the emulator as the plain version does
    for e, op in ((col("c_phone").contains("1"), "BYTESMATCH"),
                  (year(col("c_custkey")), "YEAR")):
        stages = [(None, (("x", to_port(e)),))]
        program = fused.lower_stages(t, stages)
        assert fused.OPS[op] in program.code[:, 0].tolist()
        assert_tables_equal(emulate(program, t), fused.apply_stages(t, stages))
