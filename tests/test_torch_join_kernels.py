"""The port's join kernels (``repro_torch.kernels.hash_probe`` and the
probe variant of ``repro_torch.core.fused``) and its ``HashJoin`` against
the reference, on inputs made from a seed with numpy.

On the CPU each wrapper runs its plain PyTorch version: the table must come
out bit for bit as the reference's ``build_table`` makes it, and the probes
must give exactly the reference's ``found``/``vals``/``bidx`` (its Pallas
kernels in interpret mode). The fused probe's register program also runs
through ``torch_diff.emulate_probe``, which follows the CUDA kernel's
32-bit semantics. The CUDA kernels themselves are checked by
``test_torch_gpu.py`` (skipped without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from torch_diff import emulate_probe, port_schema, to_port  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import fused as ref_fused  # noqa: E402
from repro.core import operators as ref_ops  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro.core import relational as ref_rel  # noqa: E402
from repro.core.expr import col, lit  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ops as ref_kernel_ops  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro.tpch import schema as ref_schema  # noqa: E402
from repro_torch.core import fused  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core import relational as rel  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import hash_probe as hp  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402

# the module (``repro.kernels`` re-exports a function of the same name)
ref_hp = importlib.import_module("repro.kernels.hash_probe")
I32 = np.iinfo(np.int32)


# ---------------------------------------------------------------------------
# build_table
# ---------------------------------------------------------------------------

def _build_inputs(case, seed):
    """(keys, valid, table_size) for a build case; valid rows are at most
    half the table (the planner's load factor)."""
    rng = np.random.default_rng(seed)
    if case == "unique":
        keys = rng.permutation(100_000)[:500].astype(np.int32)
        return keys, np.ones(500, bool), 1024
    if case == "duplicates":           # long runs of equal keys
        return rng.integers(0, 40, 900).astype(np.int32), np.ones(900, bool), 2048
    if case == "invalid_rows":
        keys = rng.integers(-1000, 1000, 1500).astype(np.int32)
        return keys, rng.random(1500) < 0.3, 1024
    if case == "minus_one_keys":       # placed, but their slots look empty
        keys = rng.integers(-3, 30, 700).astype(np.int32)
        return keys, rng.random(700) < 0.7, 1024
    if case == "extreme_keys":
        keys = rng.integers(I32.min, I32.max, 256, dtype=np.int64)
        keys = keys.astype(np.int32)
        keys[:3] = [I32.min, I32.max, 0]
        return keys, np.ones(256, bool), 512
    if case == "all_invalid":
        return np.arange(64, dtype=np.int32), np.zeros(64, bool), 128
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, bool), 16
    raise AssertionError(case)


_BUILD_CASES = ["unique", "duplicates", "invalid_rows", "minus_one_keys",
                "extreme_keys", "all_invalid", "empty"]


def _ref_table(keys, valid, table_size, vals=None):
    vals = np.arange(len(keys), dtype=np.int32) if vals is None else vals
    tk, tv = ref_hp.build_table(jnp.asarray(keys), jnp.asarray(vals),
                                table_size, empty_key=-1,
                                valid=jnp.asarray(valid))
    return np.array(tk), np.array(tv)


@pytest.mark.parametrize("case", _BUILD_CASES)
def test_build_table_is_bit_identical_to_reference(case):
    keys, valid, t = _build_inputs(case, seed=len(case))
    vals = np.random.default_rng(1).integers(-9, 9, len(keys)).astype(np.int32)
    want_k, want_v = _ref_table(keys, valid, t, vals)
    got_k, got_v = hp.build_table(torch.from_numpy(keys),
                                  torch.from_numpy(vals), t, empty_key=-1,
                                  valid=torch.from_numpy(valid))
    assert got_k.dtype == torch.int32 and got_v.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


def test_build_table_keeps_duplicates_in_row_order_along_their_run():
    keys = np.array([7, 7, 7, 3, 7], np.int32)
    tk, tv = hp.build_table(torch.from_numpy(keys), torch.arange(5, dtype=torch.int32), 16)
    home = int(hp.hash_home(torch.tensor([7]), 16))
    run = [(home + i) & 15 for i in range(8)]
    rows = [int(tv[s]) for s in run if int(tk[s]) == 7]
    assert rows == [0, 1, 2, 4]


def test_hash_matches_reference():
    keys = np.random.default_rng(3).integers(I32.min, I32.max, 4096,
                                             dtype=np.int64).astype(np.int32)
    for t in (1, 64, 1 << 20):
        want = np.asarray(ref_hp._hash(jnp.asarray(keys)) & (t - 1))
        got = hp.hash_home(torch.from_numpy(keys), t).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# hash_probe and probe_bound
# ---------------------------------------------------------------------------

def _probe_keys(keys, valid, n, seed):
    """Hits (valid build keys), misses, and the empty sentinel -1."""
    rng = np.random.default_rng(seed)
    pool = keys[valid & (keys != -1)] if valid.any() else np.array([5], np.int32)
    out = rng.choice(pool, n).astype(np.int32)
    miss = rng.random(n) < 0.3
    out[miss] = rng.integers(10**6, 10**7, int(miss.sum()))
    out[rng.random(n) < 0.05] = -1
    return out


@pytest.mark.parametrize("case", ["unique", "duplicates", "invalid_rows",
                                  "minus_one_keys", "extreme_keys"])
@pytest.mark.parametrize("max_probes", [2, "bound", 64])
def test_hash_probe_matches_reference_exactly(case, max_probes):
    keys, valid, t = _build_inputs(case, seed=len(case))
    tk, tv = _ref_table(keys, valid, t)
    if max_probes == "bound":
        max_probes = ref_ops._probe_bound(tk)
    probe = _probe_keys(keys, valid, 1500, seed=t)
    want_f, want_v = ref_hp.hash_probe(jnp.asarray(tk), jnp.asarray(tv),
                                       jnp.asarray(probe), empty_key=-1,
                                       max_probes=max_probes, interpret=True)
    got_f, got_v = hp.hash_probe(torch.from_numpy(tk), torch.from_numpy(tv),
                                 torch.from_numpy(probe), empty_key=-1,
                                 max_probes=max_probes)
    assert got_f.dtype == torch.bool and got_v.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# the standalone probe's edge cases: tables of 1, 2, 4 and 8 slots, a
# table of 64 slots 95% full (runs that cross 32-byte sectors of slots and
# wrap at T), max_probes of 1-7 (ending inside a sector), every key -1,
# and the keys and the table at views 1-3 elements past their bases
_EDGE_CASES = ("T=1", "T=2", "T=4", "T=8", "dense T=64", "max_probes 1-7",
               "keys -1", "views")


def _edge_inputs(case, seed):
    """[(tk, tv, probe keys, max_probes), ...] of an edge case: tables of
    keys from a small pool (duplicates along runs) and -1, probed by pool
    keys, absent keys and -1."""
    rng = np.random.default_rng(seed)

    def table(t, full, off=0):
        tk = rng.integers(0, max(t // 2, 2), t + off).astype(np.int32)
        tk[rng.random(t + off) >= full] = -1
        tv = rng.integers(I32.min, I32.max, t + off, dtype=np.int64)
        return tk[off:], tv.astype(np.int32)[off:]

    def keys(n, t, off=0):
        return rng.integers(-1, t, n + off).astype(np.int32)[off:]

    if case.startswith("T="):
        t = int(case[2:])
        tk, tv = table(t, 0.7)
        return [(tk, tv, keys(300, t), mp) for mp in (1, t)]
    if case == "dense T=64":
        tk, tv = table(64, 0.95)
        # and a table the build filled to 95%: 61 rows of 20 keys along
        # their runs
        btk, btv = _ref_table(rng.integers(0, 20, 61).astype(np.int32),
                              np.ones(61, bool), 64)
        return ([(tk, tv, keys(700, 64), mp) for mp in (9, 64)]
                + [(btk, btv, keys(700, 24), mp) for mp in (9, 64)])
    if case == "max_probes 1-7":
        tk, tv = table(64, 0.95)
        return [(tk, tv, keys(500, 64), mp) for mp in range(1, 8)]
    if case == "keys -1":
        tk, tv = table(32, 0.6)
        return [(tk, tv, np.full(99, -1, np.int32), 32)]
    if case == "views":
        return [(*table(256, 0.9, off), keys(501, 256, 3 - off), 256)
                for off in (1, 2, 3)]
    raise AssertionError(case)


@pytest.mark.parametrize("case", _EDGE_CASES)
def test_hash_probe_edge_cases_match_reference(case):
    for tk, tv, probe, mp in _edge_inputs(case, seed=len(case)):
        want_f, want_v = ref_hp.hash_probe(
            jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(probe),
            empty_key=-1, max_probes=mp, interpret=True)
        got_f, got_v = hp.hash_probe(torch.from_numpy(tk),
                                     torch.from_numpy(tv),
                                     torch.from_numpy(probe), empty_key=-1,
                                     max_probes=mp)
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        plain = hp.hash_probe_plain(torch.from_numpy(tk), torch.from_numpy(tv),
                                    torch.from_numpy(probe), -1, mp)
        np.testing.assert_array_equal(plain[0].numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(plain[1].numpy(), np.asarray(want_v))


def _bound_tables():
    rng = np.random.default_rng(5)
    full = np.arange(16, dtype=np.int32)
    wrap = np.full(16, -1, np.int32)
    wrap[[13, 14, 15, 0, 1]] = 1                 # one run across the end
    keys, valid, t = _build_inputs("duplicates", 9)
    return {"empty": np.full(32, -1, np.int32), "full": full, "wrap": wrap,
            "one_slot": np.array([4], np.int32),
            "duplicates": _ref_table(keys, valid, t)[0],
            "random": np.where(rng.random(4096) < 0.45,
                               rng.integers(0, 9, 4096), -1).astype(np.int32)}


@pytest.mark.parametrize("name", ["duplicates", "empty", "full", "one_slot",
                                  "random", "wrap"])
def test_probe_bound_matches_reference(name):
    tk = _bound_tables()[name]
    assert hp.probe_bound(torch.from_numpy(tk)) == ref_ops._probe_bound(tk)


def test_cpu_join_wrappers_mark_dispatches_and_launch_nothing():
    kernel_ops.reset_launch_counts()
    used = set()
    with kernel_ops.record_kernels(used):
        tk, tv = hp.build_table(torch.arange(8, dtype=torch.int32),
                                torch.arange(8, dtype=torch.int32), 16)
        hp.hash_probe(tk, tv, torch.arange(4, dtype=torch.int32))
    assert used == {"build", "probe"}
    assert all(v == 0 for v in kernel_ops.launch_counts().values())


# ---------------------------------------------------------------------------
# join keys
# ---------------------------------------------------------------------------

def test_join_key_matches_reference():
    c = np.array([I32.min, -1, 0, 7, I32.max], np.int32)
    want, exact = ref_rel.join_key([jnp.asarray(c)])
    got, got_exact = rel.join_key([torch.from_numpy(c)])
    assert exact and got_exact
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # any other key is the reference's hash_combine, bit for bit, and is
    # not exact: the sorted-key join verifies it after the probe
    rng = np.random.default_rng(5)
    f = rng.normal(0, 1000, 64).astype(np.float32)
    b = rng.random(64) < 0.5
    i = rng.integers(I32.min, I32.max, 64, dtype=np.int64).astype(np.int32)
    for cols in ([f], [b], [i, i[::-1].copy()], [i, f]):
        want, exact = ref_rel.join_key([jnp.asarray(x) for x in cols])
        got, got_exact = rel.join_key([torch.from_numpy(x) for x in cols])
        assert not exact and not got_exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pack", [((0, 10), (5, 3)), ((-4, 100), (0, 1)),
                                  ((I32.min, 2), (I32.max - 2, 2)),
                                  ((0, 46340), (0, 46340))])
def test_packed_key_matches_reference(pack):
    rng = np.random.default_rng(len(str(pack)))
    cols = []
    for lo, span in pack:
        c = lo + rng.integers(-3, span + 3, 500)
        c = np.clip(c, I32.min, I32.max).astype(np.int32)
        c[:2] = [I32.min, I32.max]
        cols.append(c)
    want = ref_rel.packed_key([jnp.asarray(c) for c in cols], pack,
                              empty_key=-1)
    got = rel.packed_key([torch.from_numpy(c) for c in cols], pack,
                         empty_key=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _composite(n, seed, key_dtype=rdt.INT32, span_a=50):
    rng = np.random.default_rng(seed)
    data = {"a": rng.integers(-5, span_a, n).astype(np.int32),
            "b": rng.integers(100, 140, n).astype(np.int32),
            "f": rng.normal(size=n).astype(np.float32)}
    schema = {"a": key_dtype, "b": rdt.DATE32, "f": rdt.FLOAT32}
    valid = rng.random(n) < 0.8
    ref = DeviceTable.from_numpy(data, schema)
    ref = ref.filter(jnp.asarray(valid))
    port = TorchTable.from_numpy(data, port_schema(schema), device="cpu")
    port = port.filter(torch.from_numpy(valid))
    return ref, port


@pytest.mark.parametrize("keys", [("a", "b"), ("b", "a"), ("a", "f"),
                                  ("a",)])
def test_derive_pack_matches_reference(keys):
    ref_t, port_t = _composite(300, seed=len(keys))
    assert ops._derive_pack(port_t, keys) == ref_ops._derive_pack(ref_t, keys)
    # all rows dead: the reference's empty windows
    ref_dead = ref_t.filter(jnp.zeros(300, bool))
    port_dead = port_t.filter(torch.zeros(300, dtype=torch.bool))
    assert (ops._derive_pack(port_dead, keys)
            == ref_ops._derive_pack(ref_dead, keys))


def test_derive_pack_refuses_too_wide_keys():
    ref_t, port_t = _composite(300, seed=2, span_a=I32.max // 10)
    assert ref_ops._derive_pack(ref_t, ("a", "b")) is None
    assert ops._derive_pack(port_t, ("a", "b")) is None


# ---------------------------------------------------------------------------
# the fused probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_small():
    return ref_dbgen.generate(sf=0.002)


def _scan_probe(q, scan_table):
    """The first join of Q ``q`` whose probe side is a scan of
    ``scan_table``: (scan, join)."""
    plan = ref_queries.build_query(q, ref_dbgen.load_catalog(sf=0.001))
    todo = [plan]
    while todo:
        node = todo.pop()
        if (isinstance(node, ref_plan.Join)
                and isinstance(node.probe, ref_plan.TableScan)
                and node.probe.table == scan_table):
            return node.probe, node
        todo.extend(node.children())
    raise AssertionError((q, scan_table))


def _fused_case(case, data):
    """(ref table, port table, stages, probe_keys, pack, build keys,
    build valid) for a fused probe case."""
    if case == "packed":
        ref_t, port_t = _composite(3000, seed=7)
        stages = [(col("a") > lit(0), None),
                  (None, (("a", col("a")), ("b", col("b")),
                          ("g", col("f") * lit(2.0))))]
        rng = np.random.default_rng(11)
        bkeys = [rng.integers(0, 50, 800).astype(np.int32),
                 rng.integers(100, 140, 800).astype(np.int32)]
        pack = tuple((int(k.min()), int(k.max() - k.min()) + 1)
                     for k in bkeys)
        key = np.asarray(ref_rel.packed_key([jnp.asarray(k) for k in bkeys],
                                            pack))
        return ref_t, port_t, stages, ("a", "b"), pack, key
    q, probe_table, build_table = {
        "q3_lineitem": (3, "lineitem", "orders"),
        "q3_orders": (3, "orders", "customer"),
        "q10_lineitem": (10, "lineitem", "orders")}[case]
    scan, join = _scan_probe(q, probe_table)
    sch = ref_schema.SCHEMAS[probe_table]
    cols = {c: data[probe_table][c][:3000] for c in scan.columns}
    schema = {c: sch[c] for c in scan.columns}
    # capacity not a multiple of the 1024-row block: padded rows are dead
    ref_t = DeviceTable.from_numpy(cols, schema, capacity=3100)
    port_t = TorchTable.from_numpy(cols, port_schema(schema), capacity=3100,
                                   device="cpu")
    key = data[build_table][join.build_keys[0]]
    return (ref_t, port_t, [(scan.filter, None)], tuple(join.probe_keys),
            None, key.astype(np.int32))


@pytest.mark.parametrize("case", ["q3_lineitem", "q3_orders", "q10_lineitem",
                                  "packed"])
def test_fused_probe_matches_reference_and_emulator(case, tpch_small):
    ref_t, port_t, stages, probe_keys, pack, bkey = _fused_case(case,
                                                                 tpch_small)
    valid = np.random.default_rng(2).random(len(bkey)) < 0.9
    t = 1 << int(np.ceil(np.log2(2 * len(bkey))))
    tk, tv = _ref_table(bkey, valid, t)
    max_probes = ref_ops._probe_bound(tk)
    want, want_f, want_b = ref_fused.fused_morsel_program(
        ref_t, stages, probe=dict(tk=jnp.asarray(tk), tv=jnp.asarray(tv),
                                  probe_keys=probe_keys, pack=pack,
                                  empty_key=-1, max_probes=max_probes),
        interpret=True)
    pstages = to_port(stages)
    got, found, bidx = fused.fused_morsel_program(
        port_t, pstages, probe=dict(tk=torch.from_numpy(tk),
                                    tv=torch.from_numpy(tv),
                                    probe_keys=probe_keys, pack=pack,
                                    empty_key=-1, max_probes=max_probes))
    assert found.any() and (~found).any()
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(bidx.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    assert sorted(got.column_names) == sorted(want.column_names)
    for name in want.column_names:
        a, b = got.columns[name].numpy(), np.asarray(want.columns[name])
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
    # the CUDA kernel's program, emulated, equals the plain version bit for
    # bit
    program = fused.lower_stages(port_t, pstages, probe_keys=probe_keys,
                                 pack=pack)
    assert program.probe and program.code.shape[0] <= fused.LIMITS["kMaxInstr"]
    emu, emu_f, emu_b = emulate_probe(program, port_t, tk, tv, max_probes)
    np.testing.assert_array_equal(emu_f, found.numpy())
    np.testing.assert_array_equal(emu_b, bidx.numpy())
    np.testing.assert_array_equal(emu.validity.numpy(), got.validity.numpy())
    for name in got.column_names:
        np.testing.assert_array_equal(emu.columns[name].numpy(),
                                      got.columns[name].numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# HashJoin
# ---------------------------------------------------------------------------

_BUILD_SCHEMA = {"k": rdt.INT32, "k2": rdt.DATE32, "pi": rdt.INT32,
                 "pf": rdt.FLOAT32, "ps": rdt.bytes_(4),
                 "pd": rdt.dict32(("x", "y", "z"))}
_PROBE_SCHEMA = {"k": rdt.INT32, "k2": rdt.DATE32, "v": rdt.FLOAT32}


def _join_sides(seed):
    rng = np.random.default_rng(seed)
    nb, np_ = 700, 2000
    bk = rng.permutation(5000)[:nb].astype(np.int32) - 1000
    bk[bk == -1] = 4999                       # no sentinel among build keys
    build = {"k": bk, "k2": rng.integers(9000, 9050, nb).astype(np.int32),
             "pi": rng.integers(-50, 50, nb).astype(np.int32),
             "pf": rng.normal(size=nb).astype(np.float32),
             "ps": rng.integers(0, 255, (nb, 4)).astype(np.uint8),
             "pd": rng.integers(0, 3, nb).astype(np.int32)}
    rows = rng.integers(0, nb, np_)
    pk, pk2 = bk[rows].copy(), build["k2"][rows].copy()
    miss = rng.random(np_) < 0.3
    pk[miss] = rng.integers(6000, 9000, int(miss.sum()))
    off = rng.random(np_) < 0.15          # composite misses, outside too
    pk2[off] = rng.integers(8990, 9060, int(off.sum()))
    pk[:5] = -1
    probe = {"k": pk, "k2": pk2, "v": rng.normal(size=np_).astype(np.float32)}
    bvalid = rng.random(nb) < 0.85
    pvalid = rng.random(np_) < 0.9
    return build, bvalid, probe, pvalid


def _both(data, schema, valid, capacity):
    ref = DeviceTable.from_numpy(data, schema, capacity=capacity)
    ref = ref.filter(jnp.asarray(np.pad(valid, (0, capacity - len(valid)))))
    port = TorchTable.from_numpy(data, port_schema(schema), capacity=capacity,
                                 device="cpu")
    port = port.filter(torch.from_numpy(np.pad(valid,
                                               (0, capacity - len(valid)))))
    return ref, port


@pytest.mark.parametrize("keys", [("k",), ("k", "k2")])
@pytest.mark.parametrize("join_type", ["inner", "left_semi", "left_anti",
                                       "left_outer"])
def test_hash_join_matches_reference_operator(join_type, keys):
    build, bvalid, probe, pvalid = _join_sides(seed=len(join_type))
    rb, pb = _both(build, _BUILD_SCHEMA, bvalid, 1024)
    payload = (() if join_type in ("left_semi", "left_anti")
               else ("pi", "pf", "ps", "pd"))
    with ref_kernel_ops.use_backend("pallas"):
        want_op = ref_ops.HashJoin(keys, keys, payload, join_type=join_type,
                                   build_rows=700)
        want_op.open()
        want_op.add_build(rb)
        want_op.seal_build()
        assert want_op._hash_state is not None and not want_op._multi
        outs = {}
        for lo in (0, 1000):                  # two probe batches
            rp, pp = _both({c: v[lo:lo + 1000] for c, v in probe.items()},
                           _PROBE_SCHEMA, pvalid[lo:lo + 1000], 1000)
            outs[lo] = (want_op.add_input(rp)[0], pp)
    got_op = ops.HashJoin(keys, keys, payload, join_type, build_rows=700)
    got_op.open()
    got_op.add_build(pb)
    used = set()
    with kernel_ops.record_kernels(used):
        got_op.seal_build()
    assert used == {"build"}
    assert got_op._max_probes == want_op._max_probes
    assert got_op._pack == want_op._pack
    np.testing.assert_array_equal(got_op._hash_state[1].numpy(),
                                  np.asarray(want_op._hash_state[1]))
    for want, pp in outs.values():
        (got,) = got_op.add_input(pp)
        assert sorted(got.column_names) == sorted(want.column_names)
        np.testing.assert_array_equal(got.validity.numpy(),
                                      np.asarray(want.validity))
        for name in want.column_names:
            np.testing.assert_array_equal(got.columns[name].numpy(),
                                          np.asarray(want.columns[name]),
                                          err_msg=name)
            assert got.schema[name] == to_port(want.schema[name]), name


def test_hash_join_refuses_unported_paths(monkeypatch):
    """Where the reference leaves its hash table for the sorted-key join,
    so does the port (it once raised there): a float key, a composite too
    wide to pack, a valid build key equal to the sentinel -1, a table above
    the cap. Every other join still builds its table."""
    build, bvalid, _, _ = _join_sides(seed=3)
    _, pb = _both(build, _BUILD_SCHEMA, bvalid, 1024)

    def seal(keys, join_type="inner", max_matches=1, table=pb,
             build_rows=None):
        j = ops.HashJoin(keys, keys, (), join_type, max_matches,
                         build_rows=build_rows)
        counts = {}
        j.add_build(table)
        with kernel_ops.collect_dispatches(counts):
            j.seal_build()
        sorted_path = j._state is not None
        assert sorted_path == (j._hash_state is None)
        assert counts.get("fallback_probe", 0) == int(sorted_path)
        return j

    # an expansion join (max_matches > 1) seals onto the expansion probe
    assert seal(("k",), max_matches=4)._multi
    for keys in (("pf",), ("k", "pf")):
        j = seal(keys)
        # the longest run of equal hashes (floats hash by their int32 cast,
        # so these normal floats share a few long runs)
        assert j._state is not None and not j._exact and j._window >= 1
    minus = dict(build, k=np.where(np.arange(700) == 3, -1, build["k"]))
    _, pm = _both(minus, _BUILD_SCHEMA, np.ones(700, bool), 1024)
    j = seal(("k",), table=pm)
    assert j._state is not None and j._exact
    monkeypatch.setattr(ops, "MAX_HASH_TABLE_SLOTS", 1024)
    assert seal(("k",), build_rows=513)._state is not None
    assert seal(("k",), build_rows=512)._hash_state is not None
    monkeypatch.undo()
    # semi/anti joins take any max_matches: membership alone decides
    assert seal(("k",), "left_semi", max_matches=4)._hash_state is not None


def test_port_cap_holds_a_table_above_the_reference_cap():
    """A build whose table passes the reference's 2^18-slot cap (where the
    reference takes its sorted-key path) stays on the hash path here."""
    rng = np.random.default_rng(4)
    n = 200_000
    keys = rng.permutation(10 * n)[:n].astype(np.int32)
    t = TorchTable.from_numpy({"k": keys}, port_schema({"k": rdt.INT32}),
                              device="cpu")
    j = ops.HashJoin(["k"], ["k"], build_rows=n)
    j.add_build(t)
    j.seal_build()
    assert j._hash_state[1].shape[0] == 1 << 19 > ref_ops.MAX_HASH_TABLE_SLOTS
    probe = TorchTable.from_numpy({"k": keys[::7]},
                                  port_schema({"k": rdt.INT32}), device="cpu")
    (out,) = j.add_input(probe)
    assert bool(out.validity.all())
