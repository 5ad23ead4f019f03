"""The port's tiered-memory spill subsystem (``repro_torch.core.spill``)
against the reference's ``repro.core.spill``, on the CPU.

* The reference's ``SpillManager`` unit tests on the port: reservation
  accounting, the progress guarantees, largest-first victim selection,
  the disk ceiling, the lifecycle of the spill directory.
* The bit-exact tier round trip over int32/int64 with their extremes,
  float32/64, bool and bytes, local and worker-stacked, in the host tier
  and on disk, each also held to the reference manager's round trip of
  the same arrays. Each case makes its own temporary directory (the
  reference's property test takes pytest's function-scoped ``tmp_path``
  under hypothesis, which its health check refuses).
* The ``.paged`` file the port's disk tier writes for a seeded partition,
  byte for byte the reference's.
* The bytes-aware prefetcher (``MorselPrefetcher``'s ``host_budget`` and
  ``max_bytes``) and the budget's deferred release (``release_after``,
  the pinned host tier's wait for a copy that still reads a buffer).
"""

import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_diff import port_catalog  # noqa: E402

from repro.core import dtypes as rdt  # noqa: E402
from repro.core import spill as ref_spill  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro_torch.core import dtypes as dt  # noqa: E402
from repro_torch.core.spill import (HostMemoryBudget,  # noqa: E402
                                    SpillCapacityError, SpillManager,
                                    spill_run_keys)
from repro_torch.core.streaming import MorselPrefetcher  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402


def _mgr(**kw):
    return SpillManager(device="cpu", **kw)


# ---------------------------------------------------------------------------
# reservations and budgets
# ---------------------------------------------------------------------------

def test_reservation_accounting():
    mgr = _mgr(device_budget=1000)
    assert mgr.reserve("a", 600) == 600
    assert mgr.reserve("b", 600) == 400          # clipped to what's left
    assert mgr.stats.reserve_denials == 1
    assert mgr.device_reserved() == 1000
    assert mgr.device_available() == 0
    mgr.release("a")
    assert mgr.device_reserved() == 400
    assert mgr.reserved("a") == 0 and mgr.reserved("b") == 400
    mgr.release("b", 100)                        # partial release
    assert mgr.reserved("b") == 300
    assert mgr.stats.reserved_peak == 1000
    mgr.close()


def test_reserve_minimum_oversubscribes_for_progress():
    mgr = _mgr(device_budget=100)
    assert mgr.reserve("big", 100) == 100
    assert mgr.reserve("next", 500, minimum=64) == 64
    assert mgr.device_available() == -64
    assert mgr.stats.reserve_denials == 1
    mgr.close()


def test_should_stage_tracks_available_budget():
    mgr = _mgr(device_budget=1000)
    assert not mgr.should_stage(800)
    mgr.reserve("op", 600)
    assert mgr.should_stage(800)
    assert not mgr.should_stage(400)
    mgr.close()


def test_host_budget_progress_guarantee():
    budget = HostMemoryBudget(100)
    assert budget.acquire(500)                   # oversize, nothing held
    assert budget.in_use == 500
    assert not budget.try_acquire(1)
    budget.release(500)
    assert budget.try_acquire(80) and budget.try_acquire(20)
    assert not budget.try_acquire(1)
    budget.release(100)


class _Event:
    """Stands in for a ``torch.cuda.Event``: counts its waits."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_release_after_holds_bytes_until_the_copy_completed():
    budget = HostMemoryBudget(100)
    assert budget.try_acquire(100)
    event = _Event()
    budget.release_after(event, 100)
    # a decision first waits for the copy, then sees the bytes released
    assert budget.try_acquire(60) and event.waits == 1
    assert budget.in_use == 60
    budget.release_after(None, 60)               # no copy: released now
    assert budget.in_use == 0 and event.waits == 1


def test_spill_run_keys():
    assert spill_run_keys("agg3", 3) == [("agg3", 0), ("agg3", 1),
                                         ("agg3", 2)]


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpillManager(1000)


# ---------------------------------------------------------------------------
# tiers and victim selection
# ---------------------------------------------------------------------------

def _part(n_rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(-1 << 62, 1 << 62, n_rows, dtype=np.int64),
            "v": rng.standard_normal(n_rows).astype(np.float32)}
    validity = rng.random(n_rows) < 0.9
    return cols, validity, {"k": dt.INT64, "v": dt.FLOAT32}


def test_largest_first_victim_selection(tmp_path):
    small, large, mid = _part(10, 1), _part(1000, 2), _part(100, 3)
    mgr = _mgr(device_budget=0, host_budget=2000, spill_dir=str(tmp_path))
    mgr.put_host("small", *small)
    mgr.put_host("large", *large)                # overflows the host tier
    mgr.put_host("mid", *mid)
    assert mgr.tier_of("large") == "disk"
    assert mgr.tier_of("small") == "host"
    assert mgr.stats.disk.spills >= 1
    assert mgr.stats.host.spills == 3
    for key, (cols, validity, _) in [("large", large), ("small", small),
                                     ("mid", mid)]:
        got_cols, got_validity, _ = mgr.restore_host(key)
        np.testing.assert_array_equal(got_validity, validity)
        for c in cols:
            np.testing.assert_array_equal(got_cols[c], cols[c])
    assert mgr.keys() == []
    assert not any(f.endswith(".paged") for f in os.listdir(tmp_path))
    mgr.close()


def test_disk_ceiling_raises(tmp_path):
    mgr = _mgr(device_budget=0, host_budget=0, spill_dir=str(tmp_path),
               disk_ceiling=64)
    with pytest.raises(SpillCapacityError, match="disk ceiling"):
        mgr.put_host("p", *_part(1000))
    mgr.close()


def test_close_removes_own_spill_dir():
    mgr = _mgr(device_budget=0, host_budget=0)   # every put -> disk
    mgr.put_host("p", *_part(100))
    root = mgr._dir()
    assert os.path.isdir(root)
    mgr.close()
    assert not os.path.isdir(root)
    assert mgr.stats.disk.spills == 1            # counters survive close


def test_close_removes_unread_files_from_a_given_dir(tmp_path):
    mgr = _mgr(device_budget=0, host_budget=0, spill_dir=str(tmp_path))
    mgr.put_host("p", *_part(100))
    mgr.put_host("q", *_part(50))
    mgr.drop("q")
    assert len(os.listdir(tmp_path)) == 1
    mgr.close()
    assert os.listdir(tmp_path) == []


def test_drop_releases_host_bytes():
    mgr = _mgr(device_budget=0)
    mgr.put_host("p", *_part(100))
    assert mgr.host.in_use > 0
    mgr.drop("p")
    assert mgr.host.in_use == 0 and not mgr.has("p")
    mgr.close()


# ---------------------------------------------------------------------------
# tier round trips are bit-exact, as the reference's
# ---------------------------------------------------------------------------

def _roundtrip_input(dtype_name: str, n_rows: int, stacked: bool, seed: int):
    rng = np.random.default_rng(seed)
    shape = (2, n_rows) if stacked else (n_rows,)
    if dtype_name == "bytes":
        d = "bytes"
        arr = rng.integers(0, 256, shape + (7,), dtype=np.uint8)
    elif dtype_name == "bool":
        d = "bool"
        arr = rng.random(shape) < 0.5
    elif dtype_name.startswith("int"):
        d = dtype_name
        info = np.iinfo(np.dtype(dtype_name))
        # extremes included: the disk codec must not delta-encode
        arr = rng.integers(info.min, info.max, shape, dtype=np.dtype(d))
        arr.flat[0] = info.min
        arr.flat[-1] = info.max
    else:
        d = dtype_name
        arr = rng.standard_normal(shape).astype(np.dtype(d))
    validity = rng.random(shape) < 0.8
    return d, arr, validity


def _dtypes(name):
    if name == "bytes":
        return dt.bytes_(7), rdt.bytes_(7)
    return dt.DType(name), rdt.DType(name)


@pytest.mark.parametrize("force_disk", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype_name", ["int32", "int64", "float32",
                                        "float64", "bool", "bytes"])
def test_tier_roundtrip_bit_exact(dtype_name, stacked, force_disk):
    n_rows = 1 + (len(dtype_name) * 97 + stacked * 31) % 300
    name, arr, validity = _roundtrip_input(dtype_name, n_rows, stacked,
                                           seed=n_rows)
    d, rd = _dtypes(name)
    with tempfile.TemporaryDirectory() as root:
        mgr = _mgr(device_budget=0, host_budget=0 if force_disk else 1 << 30,
                   spill_dir=os.path.join(root, "port"))
        mgr.put_host("p", {"c": arr}, validity, {"c": d})
        assert mgr.tier_of("p") == ("disk" if force_disk else "host")
        cols, got_validity, schema = mgr.restore_host("p")
        assert schema["c"].name == d.name
        np.testing.assert_array_equal(got_validity, validity)
        np.testing.assert_array_equal(cols["c"], arr)   # bit-exact
        assert cols["c"].dtype == arr.dtype and cols["c"].shape == arr.shape
        assert cols["c"].tobytes() == arr.tobytes()
        mgr.close()
        ref = ref_spill.SpillManager(
            device_budget=0, host_budget=0 if force_disk else 1 << 30,
            spill_dir=os.path.join(root, "ref"))
        ref.put_host("p", {"c": arr}, validity, {"c": rd})
        want_cols, want_validity, _ = ref.restore_host("p")
        ref.close()
    np.testing.assert_array_equal(got_validity, want_validity)
    assert cols["c"].tobytes() == np.asarray(want_cols["c"]).tobytes()


@pytest.mark.parametrize("host_budget", [1 << 30, 0])
def test_spill_table_roundtrip(host_budget):
    cols, validity, schema = _part(64, seed=7)
    cols = {"k": cols["k"].astype(np.int32), "v": cols["v"]}
    table = TorchTable.from_numpy(cols, schema, device="cpu").filter(
        torch.from_numpy(validity))
    mgr = _mgr(device_budget=0, host_budget=host_budget)
    nbytes = mgr.spill_table("t", table)
    assert nbytes == table.nbytes()
    back = mgr.restore("t")
    assert back.device == torch.device("cpu")
    for c in cols:
        assert torch.equal(back.columns[c], table.columns[c])
    assert torch.equal(back.validity, table.validity)
    assert mgr.host.in_use == 0
    mgr.close()


# ---------------------------------------------------------------------------
# the disk tier's file is the reference's, byte for byte
# ---------------------------------------------------------------------------

_FILE_CASES = {
    "mixed local": (False, ("int32", "int64", "float32", "bool", "bytes")),
    "mixed stacked": (True, ("int32", "float64", "bytes")),
    "int64 extremes": (False, ("int64",)),
}


@pytest.mark.parametrize("case", sorted(_FILE_CASES))
def test_disk_file_byte_equal_to_reference(case):
    stacked, names = _FILE_CASES[case]
    cols, schema, ref_schema = {}, {}, {}
    validity = None
    for i, name in enumerate(names):
        kind, arr, valid = _roundtrip_input(name, 2500, stacked, seed=i + 11)
        cols[f"c{i}"] = arr
        schema[f"c{i}"], ref_schema[f"c{i}"] = _dtypes(kind)
        validity = valid if validity is None else validity
    with tempfile.TemporaryDirectory() as root:
        files = {}
        for who, make, sch in (
                ("port", lambda d: _mgr(device_budget=0, host_budget=0,
                                        spill_dir=d), schema),
                ("ref", lambda d: ref_spill.SpillManager(
                    device_budget=0, host_budget=0, spill_dir=d),
                 ref_schema)):
            d = os.path.join(root, who)
            mgr = make(d)
            mgr.put_host(("grace0", "build", 0), cols, validity, sch)
            with open(os.path.join(d, "spill0.paged"), "rb") as f:
                files[who] = f.read()
            mgr.close()
    assert files["port"] == files["ref"]


# ---------------------------------------------------------------------------
# the bytes-aware prefetcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def catalog():
    return port_catalog(ref_dbgen.generate(sf=0.002))


@pytest.mark.parametrize("w", [1, 2])
def test_prefetcher_is_bytes_aware(catalog, w):
    src = catalog.get("lineitem")
    budget = HostMemoryBudget(1)     # every step oversubscribes alone
    pre = MorselPrefetcher(src._host_morsels(["l_orderkey"], 1024,
                                             num_workers=w),
                           "cpu", depth=2, host_budget=budget)
    rows = sum(int(t.num_valid()) for step in pre for t in step)
    assert rows == src.num_rows()
    assert budget.in_use == 0        # every acquired byte came back


def test_prefetcher_private_byte_cap(catalog):
    src = catalog.get("orders")
    pre = MorselPrefetcher(src._host_morsels(["o_orderkey"], 512), "cpu",
                           depth=4, max_bytes=1 << 20)
    assert pre._budget.max_bytes == 1 << 20
    rows = sum(int(step[0].num_valid()) for step in pre)
    assert rows == src.num_rows() and pre._budget.in_use == 0


def test_prefetcher_abandoned_early_gives_the_budget_back(catalog):
    src = catalog.get("lineitem")
    budget = HostMemoryBudget(1 << 30)
    pre = MorselPrefetcher(src._host_morsels(["l_orderkey"], 256), "cpu",
                           depth=3, host_budget=budget)
    it = iter(pre)
    next(it)
    it.close()                       # the consumer stops after one step
    assert budget.in_use == 0
