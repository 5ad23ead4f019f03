"""The port's sorted-key join (``relational.join_build`` / ``join_probe`` /
``semi_mask`` and ``operators._probe_join``) against the reference's
``jnp`` path, on inputs made from a seed with numpy.

``HashJoin`` takes the sorted-key path wherever the reference leaves its
hash table: a float key, a composite too wide to pack, a valid build key
equal to the table's empty sentinel -1, and a table above the cap. Each
case must give exactly the reference's output (validity and columns) at
inner, semi, anti and left-outer joins, with a unique build side
(``max_matches == 1``) and with duplicates. Hashed keys are verified
after the probe; one deliberate deviation: a probe row whose true match
sorts behind a colliding key in its hash run keeps its match (the
reference takes the first ``max_matches`` rows of the run and drops it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_diff import port_schema  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import operators as ref_ops  # noqa: E402
from repro.core import relational as ref_rel  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ops as ref_kernel_ops  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core import relational as rel  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402

I32 = np.iinfo(np.int32)
_SCHEMA = {"k": rdt.INT32, "f": rdt.FLOAT32, "w": rdt.INT32,
           "s": rdt.bytes_(3), "pi": rdt.INT32, "pf": rdt.FLOAT32,
           "bi": rdt.INT32, "bf": rdt.FLOAT32}
_CASES = {"float": ("f",), "unpackable": ("k", "w"), "minus_one": ("k",),
          "cap": ("k",), "int_float": ("k", "f"), "int_bytes": ("k", "s")}
_JOINS = ("inner", "left_semi", "left_anti", "left_outer")


def _sides(case: str, dup: bool, seed: int = 0):
    """(build, build validity, probe, probe validity): ``dup`` puts up to
    three build rows on a key; a quarter of the probe rows miss."""
    rng = np.random.default_rng(seed)
    nk = 300
    k = rng.permutation(20_000)[:nk].astype(np.int32) - 5000
    if case == "minus_one":
        k[7] = -1
    # distinct floats whose int32 casts (what hash_combine hashes) are
    # distinct too: no two keys collide, as the reference's path needs
    f = (rng.permutation(20_000)[:nk] + 0.37).astype(np.float32)
    w = rng.integers(I32.min, I32.max, nk, dtype=np.int64).astype(np.int32)
    s = rng.integers(97, 123, (nk, 3)).astype(np.uint8)
    rows = (np.repeat(np.arange(nk), rng.integers(1, 4, nk)) if dup
            else np.arange(nk))
    rng.shuffle(rows)
    nb = len(rows)
    build = {"k": k[rows], "f": f[rows], "w": w[rows], "s": s[rows],
             "bi": rng.integers(-50, 50, nb).astype(np.int32),
             "bf": rng.normal(size=nb).astype(np.float32)}
    prow = rng.integers(0, nk, 900)
    probe = {"k": k[prow], "f": f[prow], "w": w[prow], "s": s[prow],
             "pi": rng.integers(0, 9, 900).astype(np.int32),
             "pf": rng.normal(size=900).astype(np.float32)}
    miss = rng.random(900) < 0.25
    probe["k"][miss] = rng.integers(30_000, 40_000, int(miss.sum()))
    probe["f"][miss] = -1.5
    probe["s"][miss] = 32
    probe["k"][:3] = -1
    return build, rng.random(nb) < 0.9, probe, rng.random(900) < 0.9


def _both(data, valid, capacity):
    schema = {c: _SCHEMA[c] for c in data}
    ref = DeviceTable.from_numpy(data, schema, capacity=capacity)
    ref = ref.filter(jnp.asarray(np.pad(valid, (0, capacity - len(valid)))))
    port = TorchTable.from_numpy(data, port_schema(schema),
                                 capacity=capacity, device="cpu")
    port = port.filter(torch.from_numpy(
        np.pad(valid, (0, capacity - len(valid)))))
    return ref, port


def _assert_same(got: TorchTable, want) -> None:
    """Same validity, and the same values in every live row (a compacted
    expansion's dead tail holds no data)."""
    assert sorted(got.column_names) == sorted(want.column_names)
    live = np.asarray(want.validity)
    np.testing.assert_array_equal(got.validity.numpy(), live)
    for name in want.column_names:
        np.testing.assert_array_equal(got.columns[name].numpy()[live],
                                      np.asarray(want.columns[name])[live],
                                      err_msg=name)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("join_type", _JOINS)
@pytest.mark.parametrize("case", sorted(_CASES))
def test_sorted_key_join_matches_reference_jnp_path(case, join_type, dup,
                                                    monkeypatch):
    keys = _CASES[case]
    build, bvalid, probe, pvalid = _sides(case, dup, seed=len(case))
    m = 3 if dup else 1
    payload = () if join_type in ("left_semi", "left_anti") else ("bi", "bf")
    rb, pb = _both(build, bvalid, 1024)
    with ref_kernel_ops.use_backend("jnp"):
        want_op = ref_ops.HashJoin(keys, keys, payload, join_type, m)
        want_op.open()
        want_op.add_build(rb)
        want_op.seal_build()
        wants = []
        for lo in (0, 450):
            rp, pp = _both({c: v[lo:lo + 450] for c, v in probe.items()},
                           pvalid[lo:lo + 450], 512)
            wants.append((want_op.add_input(rp)[0], pp))
    if case == "cap":
        monkeypatch.setattr(ops, "MAX_HASH_TABLE_SLOTS", 256)
    got_op = ops.HashJoin(keys, keys, payload, join_type, m,
                          build_rows=len(build["k"]))
    got_op.open()
    got_op.add_build(pb)
    counts = {}
    with kernel_ops.collect_dispatches(counts):
        got_op.seal_build()
    assert got_op._hash_state is None and got_op._state is not None
    # (the -1 key's table is built first, and refused)
    assert counts["fallback_probe"] == 1
    for want, pp in wants:
        (got,) = got_op.add_input(pp)
        _assert_same(got, want)


def test_join_build_probe_and_semi_mask_match_reference():
    rng = np.random.default_rng(3)
    keys = rng.integers(-20, 20, 500).astype(np.int32)
    keys[:2] = [I32.max, I32.min]
    valid = rng.random(500) < 0.8
    pk = rng.integers(-25, 25, 400).astype(np.int32)
    pk[:2] = [I32.min, I32.max]
    pv = rng.random(400) < 0.9
    want_bt = ref_rel.join_build(jnp.asarray(keys), jnp.asarray(valid))
    got_bt = rel.join_build(torch.from_numpy(keys), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_bt.sorted_keys.numpy(),
                                  np.asarray(want_bt.sorted_keys))
    np.testing.assert_array_equal(got_bt.perm.numpy(),
                                  np.asarray(want_bt.perm))
    for m in (1, 4, 40):
        want = ref_rel.join_probe(want_bt, jnp.asarray(pk), jnp.asarray(pv), m)
        got = rel.join_probe(got_bt, torch.from_numpy(pk),
                             torch.from_numpy(pv), m)
        for name in ("probe_idx", "valid", "match_count"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        live = np.asarray(want.valid)
        np.testing.assert_array_equal(got.build_idx.numpy()[live],
                                      np.asarray(want.build_idx)[live])
    np.testing.assert_array_equal(
        rel.semi_mask(got_bt, torch.from_numpy(pk),
                      torch.from_numpy(pv)).numpy(),
        np.asarray(ref_rel.semi_mask(want_bt, jnp.asarray(pk),
                                     jnp.asarray(pv))))
    # the longest run of equal valid keys
    vals, counts = np.unique(keys[valid], return_counts=True)
    assert int(rel.longest_run(got_bt)) == counts.max()
    empty = rel.join_build(torch.zeros(0, dtype=torch.int32),
                           torch.zeros(0, dtype=torch.bool))
    assert int(rel.longest_run(empty)) == 0
    res = rel.join_probe(empty, torch.from_numpy(pk), torch.from_numpy(pv), 2)
    assert not bool(res.valid.any())


def _collision():
    """Two (int32, int32) keys with one ``hash_combine``."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 20, 400_000).astype(np.int32)
    b = rng.integers(0, 1 << 20, 400_000).astype(np.int32)
    h = rel.hash_combine([torch.from_numpy(a), torch.from_numpy(b)]).numpy()
    order = np.argsort(h, kind="stable")
    same = np.nonzero(h[order][1:] == h[order][:-1])[0]
    for i in same:
        x, y = order[i], order[i + 1]
        if (a[x], b[x]) != (a[y], b[y]):
            return (a[x], b[x]), (a[y], b[y])
    raise AssertionError("no collision in the sample")


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi"])
def test_hashed_collision_keeps_the_true_match(join_type, monkeypatch):
    """Build keys A and B collide; B sorts behind A in their hash run. A
    probe of B finds B's row (numpy truth), where the reference, taking the
    first ``max_matches == 1`` row of the run, drops it."""
    ka, kb = _collision()
    schema = {"x": rdt.INT32, "y": rdt.INT32, "pi": rdt.INT32}
    build = {"x": np.array([ka[0], kb[0]], np.int32),
             "y": np.array([ka[1], kb[1]], np.int32),
             "pi": np.array([10, 20], np.int32)}
    probe = {"x": np.array([kb[0], ka[0], 5], np.int32),
             "y": np.array([kb[1], ka[1], 5], np.int32),
             "pi": np.zeros(3, np.int32)}
    # the numpy truth: probe row 0 matches build row 1, row 1 row 0
    truth = [next((j for j in range(2) if (build["x"][j], build["y"][j])
                   == (probe["x"][i], probe["y"][i])), None) for i in range(3)]
    assert truth == [1, 0, None]
    keys = ("x", "y")
    payload = () if join_type == "left_semi" else ("pi",)
    out_payload = {"pi": "bpi"}

    def renamed(d):
        return {out_payload.get(c, c): v for c, v in d.items()}

    bschema = {out_payload.get(c, c): t for c, t in schema.items()}
    payload = tuple(out_payload[c] for c in payload)
    with ref_kernel_ops.use_backend("jnp"):
        want_op = ref_ops.HashJoin(keys, keys, payload, join_type, 1)
        want_op.add_build(DeviceTable.from_numpy(renamed(build), bschema))
        want_op.seal_build()
        want = want_op.add_input(DeviceTable.from_numpy(probe, schema))[0]
    # a cap below the table sends the composite to the sorted-key path, as
    # an unpackable one goes there
    monkeypatch.setattr(ops, "MAX_HASH_TABLE_SLOTS", 2)
    got_op = ops.HashJoin(keys, keys, payload, join_type, 1, build_rows=2)
    got_op.add_build(TorchTable.from_numpy(renamed(build),
                                           port_schema(bschema),
                                           device="cpu"))
    got_op.seal_build()
    assert got_op._state is not None and got_op._window == 2
    (got,) = got_op.add_input(TorchTable.from_numpy(probe,
                                                    port_schema(schema),
                                                    device="cpu"))
    if join_type == "left_semi":
        assert got.validity.numpy().tolist() == [True, True, False]
        return
    # (a left-outer join appends the unmatched probe rows after these)
    matched = (got.columns["__matched"].numpy() if join_type == "left_outer"
               else got.validity.numpy())
    assert matched[:3].tolist() == [True, True, False]
    assert got.columns["bpi"].numpy()[:2].tolist() == [20, 10]
    # the reference drops probe row 0 (its run starts with A, which fails
    # the verification) and keeps row 1
    ref_matched = (np.asarray(want.columns["__matched"])
                   if join_type == "left_outer" else np.asarray(want.validity))
    assert ref_matched[:3].tolist() == [False, True, False]
