"""The port's exchange layer (``repro_torch.core.exchange``), its hash
partitioning (``relational.hash32``/``hash_combine``/``partition_ids``)
and the ``radix_histogram`` kernel's plain version, against the reference
on the same seeded numpy inputs.

A reference table is worker-stacked (``[W, cap]``); the port holds one
``[cap]`` table per worker. Every exchange output must equal the
reference's off-mesh output worker by worker: capacity, validity and every
column row for row (dead rows too), with equal ``ExchangeStats``. Hashes
and histograms are integer, so every comparison here is exact.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import exchange as ref_ex  # noqa: E402
from repro.core import relational as ref_rel  # noqa: E402
from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.kernels.ops import use_pallas  # noqa: E402
from repro_torch import HostExchange, ICIExchange  # noqa: E402
from repro_torch.core import dtypes as pdt  # noqa: E402
from repro_torch.core import exchange as port_ex  # noqa: E402
from repro_torch.core import relational as port_rel  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels.radix_histogram import (  # noqa: E402
    radix_histogram, radix_histogram_plain)

# the module (``repro.kernels`` re-exports a function of the same name)
ref_hist = importlib.import_module("repro.kernels.radix_histogram")
I32 = np.iinfo(np.int32)
_STATS = ("rounds", "rows_moved", "bytes_moved", "host_staged_bytes")


# ---------------------------------------------------------------------------
# hashing and partition ids
# ---------------------------------------------------------------------------

def _int_column(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
    c[:6] = [0, -1, I32.min, I32.max, 1, -2]
    return c


def _bytes_column(n, width, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (n, width)).astype(np.uint8)
    b[0] = 255
    b[1] = 0
    return b


def test_hash32_matches_reference_bit_for_bit():
    x = _int_column(4099, seed=1)
    got = port_rel.hash32(torch.from_numpy(x))
    want = np.asarray(ref_rel.hash32(jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


_HASH_CASES = {
    "one_int": lambda n: [_int_column(n, 2)],
    "three_ints": lambda n: [_int_column(n, 3), _int_column(n, 4),
                             _int_column(n, 5)],
    "bytes": lambda n: [_bytes_column(n, 25, 6)],
    "int_bytes_int": lambda n: [_int_column(n, 7), _bytes_column(n, 10, 8),
                                _int_column(n, 9) % 97],
    "small_ints": lambda n: [np.arange(n, dtype=np.int32) % 5 - 2],
}


@pytest.mark.parametrize("case", sorted(_HASH_CASES))
def test_hash_combine_and_partition_ids_match_reference(case):
    cols = _HASH_CASES[case](3001)
    valid = np.random.default_rng(10).random(3001) < 0.8
    got = port_rel.hash_combine([torch.from_numpy(c) for c in cols])
    want = np.asarray(ref_rel.hash_combine([jnp.asarray(c) for c in cols]))
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's host-staged baseline hashes with numpy; the port's
    # HostExchange hashes with hash_combine, so the two agree too
    np.testing.assert_array_equal(got.numpy(), ref_ex._hash_combine_np(cols))
    for w in (1, 2, 3, 4, 8):
        got = port_rel.partition_ids([torch.from_numpy(c) for c in cols],
                                     torch.from_numpy(valid), w)
        want = np.asarray(ref_rel.partition_ids(
            [jnp.asarray(c) for c in cols], jnp.asarray(valid), w))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# radix_histogram (plain version; the kernel runs on the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 5000])
@pytest.mark.parametrize("p", [1, 2, 4, 8, 64])
def test_radix_histogram_matches_reference_and_pallas(n, p):
    rng = np.random.default_rng(n * 100 + p)
    pids = rng.integers(-3, p + 3, n).astype(np.int32)
    if n:
        pids[0] = I32.max
    kernel_ops.reset_launch_counts()
    got = radix_histogram(torch.from_numpy(pids), p)
    assert kernel_ops.launch_counts()["radix_histogram"] == 0   # CPU: plain
    assert got.dtype == torch.int32 and got.shape == (p,)
    want = np.asarray(ref_oracle.radix_histogram(jnp.asarray(pids), p))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(ref_hist.radix_histogram(jnp.asarray(pids), p,
                                                 interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        radix_histogram_plain(torch.from_numpy(pids), p).numpy(),
        np.bincount(pids[(pids >= 0) & (pids < p)], minlength=p))


# ---------------------------------------------------------------------------
# exchanges, worker by worker
# ---------------------------------------------------------------------------

_REF_SCHEMA = {"k": rdt.INT32, "k2": rdt.DATE32, "v": rdt.FLOAT32,
               "b": rdt.BOOL, "s": rdt.bytes_(6)}
_PORT_SCHEMA = {"k": pdt.INT32, "k2": pdt.DATE32, "v": pdt.FLOAT32,
                "b": pdt.BOOL, "s": pdt.bytes_(6)}


def _stacked(w, cap, seed, keys="wide", valid="random"):
    rng = np.random.default_rng(seed)
    if keys == "skew_one":            # every row hashes to one partition
        k = np.full((w, cap), 7, np.int32)
    elif keys == "few":
        k = rng.integers(0, 3, (w, cap)).astype(np.int32)
    else:                             # negatives and extremes included
        k = rng.integers(-1000, 1000, (w, cap)).astype(np.int32)
        if cap:
            k[0, 0], k[-1, -1] = I32.min, I32.max
    cols = {"k": k,
            "k2": rng.integers(8000, 8100, (w, cap)).astype(np.int32),
            "v": rng.normal(0, 1, (w, cap)).astype(np.float32),
            "b": rng.random((w, cap)) < 0.5,
            "s": rng.integers(0, 256, (w, cap, 6)).astype(np.uint8)}
    if valid == "none":
        v = np.zeros((w, cap), bool)
    elif valid == "one_worker":
        v = np.zeros((w, cap), bool)
        v[0] = True
    else:
        v = rng.random((w, cap)) < 0.7
    return cols, v


def _ref_table(cols, valid):
    return DeviceTable({n: jnp.asarray(a) for n, a in cols.items()},
                       jnp.asarray(valid), dict(_REF_SCHEMA))


def _port_tables(cols, valid):
    return [TorchTable({n: torch.from_numpy(np.ascontiguousarray(a[k]))
                        for n, a in cols.items()},
                       torch.from_numpy(np.ascontiguousarray(valid[k])),
                       dict(_PORT_SCHEMA))
            for k in range(valid.shape[0])]


def _assert_per_worker(got, want):
    w = want.validity.shape[0]
    assert len(got) == w
    for k in range(w):
        t = got[k]
        assert t.capacity == want.validity.shape[1]
        np.testing.assert_array_equal(t.validity.numpy(),
                                      np.asarray(want.validity[k]))
        assert sorted(t.column_names) == sorted(want.columns)
        for n in t.column_names:
            np.testing.assert_array_equal(t.columns[n].numpy(),
                                          np.asarray(want.columns[n][k]),
                                          err_msg=f"worker {k} column {n}")


def _assert_same_stats(port, ref):
    for f in _STATS:
        assert getattr(port.stats, f) == getattr(ref.stats, f), f


_CASES = [(w, cap, keys, valid)
          for w in (1, 2, 4, 8)
          for cap, keys, valid in ((300, "wide", "random"),
                                   (64, "few", "random"),
                                   (50, "skew_one", "random"),
                                   (40, "wide", "one_worker"),
                                   (16, "wide", "none"),
                                   (0, "wide", "random"))]


def _case_id(c):
    return f"W{c[0]}-cap{c[1]}-{c[2]}-{c[3]}"


@pytest.mark.parametrize("proto", ["ici", "host"])
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_repartition_matches_reference_per_worker(case, proto):
    w, cap, keys, valid = case
    cols, v = _stacked(w, cap, seed=w * 1000 + cap, keys=keys, valid=valid)
    port, ref = ((ICIExchange(), ref_ex.ICIExchange()) if proto == "ici"
                 else (HostExchange(), ref_ex.HostExchange()))
    for key_names in (("k",), ("k", "s", "k2")):
        want = ref.repartition(_ref_table(cols, v), key_names, w)
        got = port.repartition(_port_tables(cols, v), key_names, w)
        _assert_per_worker(got, want)
    _assert_same_stats(port, ref)


@pytest.mark.parametrize("proto", ["ici", "host"])
@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_broadcast_matches_reference_per_worker(case, proto):
    w, cap, keys, valid = case
    cols, v = _stacked(w, cap, seed=w * 1000 + cap + 1, keys=keys,
                       valid=valid)
    port, ref = ((ICIExchange(), ref_ex.ICIExchange()) if proto == "ici"
                 else (HostExchange(), ref_ex.HostExchange()))
    want = ref.broadcast(_ref_table(cols, v), w)
    got = port.broadcast(_port_tables(cols, v), w)
    _assert_per_worker(got, want)
    _assert_same_stats(port, ref)


def test_ici_repartition_counts_one_partition_dispatch_and_no_host_bytes():
    cols, v = _stacked(4, 200, seed=3)
    dispatch = {}
    ex = ICIExchange()
    with kernel_ops.collect_dispatches(dispatch):
        ex.repartition(_port_tables(cols, v), ("k",), 4)
        ex.broadcast(_port_tables(cols, v), 4)
    assert dispatch == {"partition": 1}
    assert ex.stats.host_staged_bytes == 0
    # the reference's pallas path counts the same
    ref_dispatch = {}
    from repro.kernels.ops import collect_dispatches as ref_collect
    with use_pallas(), ref_collect(ref_dispatch):
        ref_ex.ICIExchange().repartition(_ref_table(cols, v), ("k",), 4)
    assert ref_dispatch == dispatch
    host = {}
    with kernel_ops.collect_dispatches(host):
        HostExchange().repartition(_port_tables(cols, v), ("k",), 4)
    assert host == {}


@pytest.mark.parametrize("proto", [ICIExchange, HostExchange])
def test_clone_starts_with_zeroed_stats(proto):
    cols, v = _stacked(2, 32, seed=4)
    ex = proto()
    ex.repartition(_port_tables(cols, v), ("k",), 2)
    assert ex.stats.rounds == 1 and ex.stats.rows_moved > 0
    twin = ex.clone()
    assert type(twin) is proto and twin.stats == port_ex.ExchangeStats()
    assert ex.stats.rounds == 1       # the original keeps its counters


@pytest.mark.parametrize("w,cap,valid", [(1, 4096, "sparse"), (4, 4096, "sparse"),
                                         (4, 64, "dense"), (3, 1000, "none")])
def test_maybe_compact_matches_reference_per_worker(w, cap, valid):
    cols, v = _stacked(w, cap, seed=cap + w)
    rng = np.random.default_rng(w)
    if valid == "sparse":
        v = rng.random((w, cap)) < 0.05
    elif valid == "none":
        v[:] = False
    want = ref_ex.maybe_compact(_ref_table(cols, v))
    got = port_ex.maybe_compact(_port_tables(cols, v))
    _assert_per_worker(got, want)
