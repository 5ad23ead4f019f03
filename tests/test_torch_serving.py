"""Serving with inter-query batching in the PyTorch port: tier-1 versions
of the reference's ``-m batching`` tests (``tests/test_batching.py``) on
``Session(device="cpu")``. A seeded workload of distinct-literal small
queries in three shapes (point lookup, filtered global aggregate,
low-cardinality group-by) goes through the batching scheduler from client
threads and must equal scheduler-less serial execution, forming stacked
launches; the disabled path stays inert; a table re-registration splits
batches; a program whose ``max_groups`` passes the stacked limit runs
solo; a stacked run that raises still delivers every member's solo result
and counts one fallback.

Tolerances: keys, integers and counts exact; floats rtol 1e-5 (the
reference's own for stacked against serial on the CPU)."""

import functools
import threading
import types

import numpy as np
import pytest

from repro.core.scheduler import QueryScheduler as RefScheduler
from repro.core.scheduler import SchedulerConfig as RefSchedulerConfig
from repro.tpch import dbgen as ref_dbgen

from torch_diff import port_catalog

from repro_torch import SchedulerConfig
from repro_torch.core import batch as B
from repro_torch.core import dtypes as dt
from repro_torch.core import plan as P
from repro_torch.core.builder import QueryBuilder
from repro_torch.core.expr import col
from repro_torch.core.session import InMemoryTable, Session
from repro_torch.kernels import segmented_agg as segagg

SF = 0.005
BATCH_ROWS = 16384


@functools.lru_cache(maxsize=1)
def dataset():
    return ref_dbgen.generate(sf=SF)


@pytest.fixture()
def catalog():
    # function-scoped: tests register tables
    return port_catalog(dataset())


def _session(catalog, **config):
    session = Session(catalog, device="cpu", batch_rows=BATCH_ROWS)
    base = dict(memory_budget=512 << 20, max_concurrency=4, max_queue=256,
                cache_results=False, batching=True, batch_window_ms=150.0,
                max_batch=32)
    base.update(config)
    session.scheduler_config = SchedulerConfig(**base)
    return session


def _workload(catalog, n: int):
    """``n`` distinct-literal small queries cycling three batchable
    shapes (point lookup / filtered global agg / low-card group-by)."""
    order_keys = np.asarray(dataset()["orders"]["o_orderkey"])
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            key = int(order_keys[(i * 29) % len(order_keys)])
            out.append(QueryBuilder.scan(catalog, "orders")
                       .filter(col("o_orderkey") == key)
                       .project("o_orderkey", "o_totalprice"))
        elif kind == 1:
            out.append(QueryBuilder.scan(catalog, "lineitem")
                       .filter(col("l_quantity") < float(2 + (i % 47)))
                       .project(rev=col("l_extendedprice")
                                * col("l_discount"))
                       .agg(total=("sum", "rev"), n=("count", None)))
        else:
            out.append(QueryBuilder.scan(catalog, "lineitem")
                       .filter(col("l_quantity") < float(3 + (i % 43)))
                       .group_by("l_returnflag")
                       .agg(total=("sum", "l_extendedprice"),
                            n=("count", None)))
    return out


def _submit_concurrently(session, builders, n_clients: int = 4):
    """Submit from client threads (so the batch window sees stragglers);
    returns handles in builder order."""
    handles: list = [None] * len(builders)
    errors: list = []

    def client(c: int):
        try:
            for i in range(c, len(builders), n_clients):
                handles[i] = session.submit(builders[i])
        except Exception as exc:  # noqa: BLE001 -- re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a client thread hung"
    if errors:
        raise errors[0]
    session.gather(*handles)
    return handles


def _assert_columns_equal(ref: dict, got: dict, label: str) -> None:
    assert set(ref) == set(got), f"{label}: column sets differ"
    for c in ref:
        r, g = np.asarray(ref[c]), np.asarray(got[c])
        assert r.shape == g.shape, f"{label}.{c}: {r.shape} != {g.shape}"
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{label}.{c}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{label}.{c}")


def _serial(catalog, builders):
    serial = Session(catalog, device="cpu", batch_rows=BATCH_ROWS)
    return [serial.execute(b.optimized()) for b in builders]


def test_batched_equals_serial(catalog):
    builders = _workload(catalog, 24)
    refs = _serial(catalog, builders)
    session = _session(catalog)
    try:
        handles = _submit_concurrently(session, builders)
        stats = session.scheduler().stats()
        assert stats["batches"] >= 1, "no stacked launch formed"
        assert stats["batched_queries"] >= 2
        assert stats["batch_fallbacks"] == 0
        batched = [h for h in handles if "batch" in h.executor_stats]
        assert len(batched) == stats["batched_queries"]
        for h in batched:
            b = h.executor_stats["batch"]
            assert b["size"] >= 2 and b["queue_delay_s"] >= 0.0
            # one fused_batch dispatch per morsel of the stacked scan
            kd = h.executor_stats["kernel_dispatch"]
            morsels = sum(t["morsels"]
                          for t in h.executor_stats["tables"].values())
            assert kd["fused_batch"] == morsels >= 1
        for i, h in enumerate(handles):
            _assert_columns_equal(refs[i], h.result(), f"q{i}")
    finally:
        session.scheduler().close()


def test_disabled_batching_is_inert(catalog):
    builders = _workload(catalog, 6)
    refs = _serial(catalog, builders)
    assert SchedulerConfig().batching is False   # opt-in by default
    session = _session(catalog, batching=False)
    try:
        handles = _submit_concurrently(session, builders)
        stats = session.scheduler().stats()
        assert stats["batches"] == 0 and stats["batched_queries"] == 0
        for i, h in enumerate(handles):
            # the disabled path never inspects the plan for batchability
            assert h._batch_shape is None and h._batch_key is None
            assert "batch" not in h.executor_stats
            assert "fused_batch" not in h.executor_stats["kernel_dispatch"]
            _assert_columns_equal(refs[i], h.result(), f"q{i}")
    finally:
        session.scheduler().close()


def test_snapshot_version_gates_compatibility(catalog):
    """Re-registering a table bumps its version; queries admitted across
    the bump share a program but never a stacked launch."""
    session = _session(catalog)
    try:
        q = _workload(catalog, 1)[0]
        h1 = session.submit(q)
        r1 = h1.result(timeout=60)
        catalog.register(catalog.get("orders"))   # same data, new version
        h2 = session.submit(q)
        r2 = h2.result(timeout=60)
        assert h1._batch_key == h2._batch_key      # same interned program
        assert h1._batch_key[1] == "cpu"           # the device type keys it
        assert h1._versions != h2._versions        # ...different snapshot
        _assert_columns_equal(r1, r2, "across-version")
    finally:
        session.scheduler().close()


def test_batch_limit_caps_keyed_programs(catalog):
    session = _session(catalog)
    sch = session.scheduler()
    keyed = B.extract_shape(QueryBuilder.scan(catalog, "lineitem")
                            .group_by("l_returnflag")
                            .agg(n=("count", None)).optimized())
    assert sch._batch_limit(keyed.program) == min(
        sch.config.max_batch,
        segagg.stacked_group_capacity(keyed.program.max_groups))
    glob = types.SimpleNamespace(group_keys=(), max_groups=1)
    assert sch._batch_limit(glob) == sch.config.max_batch
    over = types.SimpleNamespace(group_keys=("k",),
                                 max_groups=segagg.STACKED_GROUP_LIMIT + 1)
    assert sch._batch_limit(over) == 1
    sch.close()
    # max_batch, as in the reference, above the CUDA kernel's 64-lane word
    # too (fused_batch_program launches once per run of 64 lanes)
    wide = _session(catalog, max_batch=128).scheduler()
    ref = RefScheduler(None, RefSchedulerConfig(max_batch=128))
    assert wide._batch_limit(glob) == 128 == ref._batch_limit(glob)
    wide.close()


def test_capacity_overflow_degrades_to_solo(catalog):
    """A keyed program whose ``max_groups`` alone passes the stacked group
    limit runs solo (no batch ever forms) and stays correct."""
    n = segagg.STACKED_GROUP_LIMIT + 100         # row bound > the limit
    rng = np.random.default_rng(3)
    catalog.register_numpy("wide_groups",
                           {"k": rng.integers(0, n, n).astype(np.int32),
                            "v": rng.random(n).astype(np.float32)},
                           {"k": dt.INT32, "v": dt.FLOAT32})

    def q(lo: float):
        return (QueryBuilder.scan(catalog, "wide_groups")
                .filter(col("v") > lo)
                .group_by("k").agg(total=("sum", "v"), cnt=("count", None)))

    builders = [q(0.1 + 0.01 * i) for i in range(3)]
    refs = _serial(catalog, builders)
    shape = B.extract_shape(builders[0].optimized())
    assert shape is not None
    assert shape.program.max_groups > segagg.STACKED_GROUP_LIMIT
    session = _session(catalog)
    try:
        assert session.scheduler()._batch_limit(shape.program) == 1
        handles = _submit_concurrently(session, builders, n_clients=3)
        assert session.scheduler().stats()["batches"] == 0
        for i, h in enumerate(handles):
            assert "batch" not in h.executor_stats
            _assert_columns_equal(refs[i], h.result(), f"q{i}")
    finally:
        session.scheduler().close()


def test_stacked_failure_falls_back_to_solo(catalog, monkeypatch):
    """A stacked run that raises still delivers each member's solo result;
    the fallback is counted once and recorded on every member."""
    def broken_run_batch(driver, shapes, lanes=None):
        raise RuntimeError("stacked run broke")

    monkeypatch.setattr(B, "run_batch", broken_run_batch)
    gate = threading.Event()
    catalog.register(_Gated("gated", gate))
    builders = [b for i, b in enumerate(_workload(catalog, 12)) if i % 3 == 2]
    refs = _serial(catalog, builders)
    session = _session(catalog, max_concurrency=1)
    try:
        # the one worker holds the gated query while the four compatible
        # members queue; it then claims them as one batch
        blocker = session.submit(P.TableScan("gated"))
        handles = [session.submit(b) for b in builders]
    finally:
        gate.set()
    try:
        session.gather(blocker, *handles)
        stats = session.scheduler().stats()
        assert stats["batch_fallbacks"] == 1
        assert stats["batches"] == 0 and stats["failed"] == 0
        assert stats["completed"] == 1 + len(builders)
        for i, h in enumerate(handles):
            fb = h.executor_stats["batch"]
            assert fb["size"] == len(builders)
            assert "stacked run broke" in fb["fallback"]
            _assert_columns_equal(refs[i], h.result(), f"q{i}")
    finally:
        session.scheduler().close()


class _Gated(InMemoryTable):
    """A tiny table whose scan blocks until ``gate`` is set."""

    def __init__(self, name, gate):
        super().__init__(name, {"k": np.arange(8, dtype=np.int32)},
                         {"k": dt.INT32})
        self.gate = gate

    def _host_morsels(self, *args, **kwargs):
        assert self.gate.wait(timeout=30.0), "test gate never opened"
        yield from super()._host_morsels(*args, **kwargs)
