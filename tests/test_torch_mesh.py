"""The port's on-mesh execution (``repro_torch.launch.mesh``, the staged
all-to-all of ``ICIExchange(mesh=...)`` and ``Session(mesh=...)``)
against the reference's on-mesh path on a one-device JAX mesh
(``repro.launch.mesh.make_engine_mesh(1)``), on the same seeded numpy
inputs.

The port runs on ``EngineMesh([cpu])``. Layouts, the all-to-all and the
receive-side compaction are integer index work, so every comparison is
exact: gather indices, validity, and every row of every column, dead slots
included, with equal ``ExchangeStats``. The queries from files and through
the host-staged exchange are the ports of ``tests/test_system.py``'s two
distributed tests, on a mesh.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_exchange import (  # noqa: E402
    _assert_per_worker, _port_tables, _ref_table, _stacked)
from torch_diff import port_catalog  # noqa: E402
from tpch_util import assert_results_match  # noqa: E402

from repro.core import exchange as ref_ex  # noqa: E402
from repro.core import relational as ref_rel  # noqa: E402
from repro.launch.mesh import make_engine_mesh as ref_engine_mesh  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro_torch import (ExecutionOptions, HostExchange,  # noqa: E402
                         ICIExchange, Session)
from repro_torch.core import exchange as port_ex  # noqa: E402
from repro_torch.core import relational as port_rel  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels.radix_histogram import (  # noqa: E402
    partition_histogram)
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh  # noqa: E402
from repro_torch.tpch import dbgen, queries  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
_STATS = ("rounds", "rows_moved", "bytes_moved", "host_staged_bytes")
_WS = (1, 2, 3, 4, 8)


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_engine_mesh(1)


def _cpu_mesh():
    return EngineMesh([CPU])


# ---------------------------------------------------------------------------
# EngineMesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("w", [4, 8])
def test_device_of_places_contiguous_blocks(d, w):
    # NamedSharding(mesh, P("workers")) splits [W, ...] into D blocks of W / D
    devs = [torch.device("cuda", i) for i in range(d)]
    mesh = EngineMesh(devs)
    got = [mesh.device_of(k, w) for k in range(w)]
    blocks = np.array_split(np.arange(w), d)
    want = [devs[b] for b in range(d) for _ in blocks[b]]
    assert got == want == mesh.worker_devices(w)
    assert mesh.size == d and mesh.check(w) == w // d


@pytest.mark.parametrize("d,w", [(2, 3), (4, 6), (4, 2), (2, 0)])
def test_uneven_split_raises(d, w):
    mesh = EngineMesh([torch.device("cuda", i) for i in range(d)])
    with pytest.raises(ValueError, match="do not split evenly"):
        mesh.device_of(0, w)


def test_make_engine_mesh_needs_as_many_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="need as many CUDA devices"):
        make_engine_mesh(2)


# ---------------------------------------------------------------------------
# the data phase's functions, against the reference's
# ---------------------------------------------------------------------------

_LAYOUT_CASES = [(n, p, cap, valid)
                 for n, p, cap, valid in ((0, 4, 2, "random"),
                                          (1, 1, 1, "random"),
                                          (37, 3, 64, "random"),
                                          (500, 4, 16, "random"),   # overflow
                                          (500, 8, 256, "random"),
                                          (200, 2, 128, "none"),
                                          (333, 5, 8, "all"))]


@pytest.mark.parametrize("case", _LAYOUT_CASES,
                         ids=lambda c: f"n{c[0]}-P{c[1]}-cap{c[2]}-{c[3]}")
def test_partition_layout_matches_reference(case):
    n, p, cap, valid = case
    rng = np.random.default_rng(n * 7 + p)
    pids = rng.integers(0, p, n).astype(np.int32)
    v = {"random": rng.random(n) < 0.7, "none": np.zeros(n, bool),
         "all": np.ones(n, bool)}[valid]
    got_idx, got_valid = port_rel.partition_layout(
        torch.from_numpy(pids), torch.from_numpy(v), p, cap)
    want_idx, want_valid = ref_rel.partition_layout(
        jnp.asarray(pids), jnp.asarray(v), p, cap)
    assert got_idx.dtype == torch.int32 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    if valid == "random" and n > p * cap:
        assert int(got_valid.sum()) < int(v.sum())    # rows were dropped


_KEYS = {"int32": ("k",), "float32": ("v",), "bytes": ("s",),
         "three": ("k", "s", "k2")}
# (W, rows a worker, keys, validity, part_cap, key columns): every W with
# a partition past part_cap, each key type, every row dead, one live worker
_STAGED_CASES = ([(w, 300, "wide", "random", 16, "int32") for w in _WS]
                 + [(4, 300, "wide", "random", 128, k)
                    for k in ("float32", "bytes", "three")]
                 + [(3, 64, "few", "random", 64, "int32"),
                    (4, 40, "wide", "one_worker", 64, "three"),
                    (8, 16, "wide", "none", 4, "int32")])


def _staged_id(c):
    return f"W{c[0]}-cap{c[1]}-{c[2]}-{c[3]}-part{c[4]}-{c[5]}"


@pytest.mark.parametrize("case", _STAGED_CASES, ids=_staged_id)
def test_layout_exchange_and_compaction_match_reference(case, ref_mesh):
    w, cap, keys, valid, part_cap, key = case
    names = _KEYS[key]
    cols, v = _stacked(w, cap, seed=w * 31 + cap + part_cap, keys=keys,
                       valid=valid)
    # step 1: each source's [W_dst, part_cap] send buffers
    want = ref_ex._partition_layout_table(_ref_table(cols, v), names, w,
                                          part_cap)
    tables = _port_tables(cols, v)
    pids, _ = partition_histogram(
        [[t.columns[k] for k in names] for t in tables],
        [t.validity for t in tables], w)
    sends = [port_ex._partition_layout_table(t, p, w, part_cap)
             for t, p in zip(tables, torch.split(
                 pids, [t.capacity for t in tables]))]
    for s, t in enumerate(sends):
        assert t.capacity == w * part_cap
        np.testing.assert_array_equal(
            t.validity.numpy(), np.asarray(want.validity[s]).reshape(-1))
        for n in t.column_names:
            a = np.asarray(want.columns[n][s])
            np.testing.assert_array_equal(
                t.columns[n].numpy(), a.reshape((-1,) + a.shape[2:]),
                err_msg=f"source {s} column {n}")
    # step 2: the all-to-all, destination d's [W_src * part_cap] buffer
    ref_ici = ref_ex.ICIExchange(mesh=ref_mesh)
    port_ici = ICIExchange(mesh=_cpu_mesh())
    received = ref_ici._exchange_data(want, w, part_cap)
    got = port_ici._exchange_data(sends, part_cap)
    _assert_per_worker(got, received)
    assert port_ici.peer_bytes == 0           # one device: no peer copy
    # step 3: receive-side compaction
    out_cap = max(1, part_cap // 2)
    _assert_per_worker(port_ex._compact_stacked(got, out_cap),
                       ref_ex._compact_stacked(received, out_cap))


# ---------------------------------------------------------------------------
# ICIExchange(mesh=...) and HostExchange on a mesh, worker by worker
# ---------------------------------------------------------------------------

# every W with a spread of keys; W = 4 also with skew, one live worker,
# every row dead, a few live rows in many slots (the send side compacts)
# and 0-row tables
_CASES = ([(w, 300, "wide", "random") for w in _WS]
          + [(4, cap, keys, valid)
             for cap, keys, valid in ((64, "few", "random"),
                                      (50, "skew_one", "random"),
                                      (40, "wide", "one_worker"),
                                      (16, "wide", "none"),
                                      (4096, "wide", "sparse"),
                                      (0, "wide", "random"))]
          + [(8, 4096, "wide", "sparse")])


def _case_id(c):
    return f"W{c[0]}-cap{c[1]}-{c[2]}-{c[3]}"


def _inputs(w, cap, keys, valid, seed):
    cols, v = _stacked(w, cap, seed=seed, keys=keys,
                       valid="random" if valid == "sparse" else valid)
    if valid == "sparse":     # few live rows: the send side compacts
        v = np.random.default_rng(seed).random((w, cap)) < 0.01
    return cols, v


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_mesh_repartition_matches_reference_per_worker(case, ref_mesh):
    w, cap, keys, valid = case
    cols, v = _inputs(w, cap, keys, valid, seed=w * 1000 + cap + 7)
    port = ICIExchange(mesh=_cpu_mesh())
    ref = ref_ex.ICIExchange(mesh=ref_mesh)
    for names in (("k",), ("k", "s", "k2"), ("v",)):
        want = ref.repartition(_ref_table(cols, v), names, w)
        got = port.repartition(_port_tables(cols, v), names, w)
        _assert_per_worker(got, want)
    for f in _STATS:
        assert getattr(port.stats, f) == getattr(ref.stats, f), f


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_mesh_broadcast_matches_reference_per_worker(case, ref_mesh):
    w, cap, keys, valid = case
    cols, v = _inputs(w, cap, keys, valid, seed=w * 1000 + cap + 8)
    port = ICIExchange(mesh=_cpu_mesh())
    ref = ref_ex.ICIExchange(mesh=ref_mesh)
    want = ref.broadcast(_ref_table(cols, v), w)
    got = port.broadcast(_port_tables(cols, v), w)
    _assert_per_worker(got, want)
    for f in _STATS:
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    # a replica a worker, not one shared table
    assert len({id(t) for t in got}) == w


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_mesh_matches_off_mesh_live_rows(case):
    w, cap, keys, valid = case
    cols, v = _inputs(w, cap, keys, valid, seed=w * 1000 + cap + 9)
    tables = _port_tables(cols, v)
    if w > 1 and cap:     # a worker with a 0-row table among full ones
        t = tables[1]
        tables[1] = TorchTable({n: a[:0] for n, a in t.columns.items()},
                               t.validity[:0], t.schema)
    on, off = ICIExchange(mesh=_cpu_mesh()), ICIExchange()
    for got, want in ((on.repartition(tables, ("k", "s"), w),
                       off.repartition(tables, ("k", "s"), w)),
                      (on.broadcast(tables, w), off.broadcast(tables, w))):
        for a, b in zip(got, want):
            la, lb = a.to_numpy(), b.to_numpy()
            for n in lb:
                np.testing.assert_array_equal(la[n], lb[n])
    for f in _STATS:
        assert getattr(on.stats, f) == getattr(off.stats, f), f


def test_host_exchange_places_each_destination_on_its_worker():
    cols, v = _stacked(2, 64, seed=5)
    tables = _port_tables(cols, v)
    got = HostExchange().repartition(tables, ("k",), 2)
    assert [t.device for t in got] == [CPU, CPU]
    want = ref_ex.HostExchange().repartition(_ref_table(cols, v), ("k",), 2)
    _assert_per_worker(got, want)


def test_clone_keeps_mesh():
    mesh = _cpu_mesh()
    ex = ICIExchange(mesh=mesh)
    cols, v = _stacked(2, 32, seed=4)
    ex.repartition(_port_tables(cols, v), ("k",), 2)
    twin = ex.clone()
    assert twin.mesh is mesh
    assert twin.stats == port_ex.ExchangeStats() and ex.stats.rounds == 1


# ---------------------------------------------------------------------------
# Session(mesh=...)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=0.002)


def _mesh_session(catalog, **kw):
    kw.setdefault("num_workers", 4)
    return Session(catalog, device="cpu", batch_rows=8192, mesh=_cpu_mesh(),
                   **kw)


def test_host_exchange_on_a_mesh_is_mechanism_baseline(data):
    """``test_system.py::test_host_exchange_is_mechanism_baseline`` on a
    mesh: both protocols agree, only the host one stages bytes."""
    catalog = port_catalog(data)
    plan = queries.build_query(13, catalog, num_workers=4)
    ici = _mesh_session(catalog)
    host = _mesh_session(catalog, exchange=HostExchange())
    res_i, res_h = ici.execute(plan), host.execute(plan)
    np.testing.assert_array_equal(np.sort(res_i["c_count"]),
                                  np.sort(res_h["c_count"]))
    assert_results_match(res_h, oracle.ORACLES[13](data), 13)

    def staged(session):
        return sum(e["host_staged_bytes"]
                   for e in session.executor_stats()["exchanges"].values())

    assert staged(ici) == 0 and staged(host) > 0


def test_full_pipeline_from_files_on_a_mesh(tmp_path):
    """``test_system.py::test_full_pipeline_storage_to_result`` on a mesh:
    column-chunk files -> mesh scan -> join/agg -> the oracle's rows, with
    no byte through the host."""
    rows = dbgen.write_dataset(str(tmp_path), sf=0.002, chunks=4)
    catalog = dbgen.storage_catalog(str(tmp_path))
    session = _mesh_session(catalog)
    res = session.execute(queries.build_query(5, catalog, num_workers=4))
    want = oracle.ORACLES[5](rows)
    np.testing.assert_allclose(np.sort(res["revenue"]),
                               np.sort(want["revenue"]), rtol=2e-3)
    stats = session.executor_stats()
    assert stats["worker_devices"] == ["cpu"] * 4
    assert stats["exchanges"] and all(
        e["host_staged_bytes"] == 0 for e in stats["exchanges"].values())


def test_mesh_session_sql_collect_and_explain(data):
    catalog = port_catalog(data)
    session = _mesh_session(catalog)
    got = session.sql("SELECT l_returnflag, count(*) AS n FROM lineitem "
                      "GROUP BY l_returnflag ORDER BY l_returnflag").collect()
    off = Session(catalog, device="cpu", batch_rows=8192, num_workers=4)
    want = off.sql("SELECT l_returnflag, count(*) AS n FROM lineitem "
                   "GROUP BY l_returnflag ORDER BY l_returnflag").collect()
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    text = session.explain(queries.build_query(3, catalog, num_workers=4),
                           analyze=True)
    assert "== executor stats ==" in text and "[ici]" in text
    assert session.context().exchange.mesh is session.mesh


def test_mesh_session_refuses_what_is_not_ported(data):
    # once refused on a mesh, now ported: the serving entry points,
    # ``device_budget`` and ``feedback`` run on a mesh session and give
    # the oracle's answer
    catalog = port_catalog(data)
    session = _mesh_session(catalog)
    plan = queries.build_query(6, catalog, num_workers=4)
    want = oracle.ORACLES[6](data)
    try:
        assert session.scheduler() is session.scheduler()
        assert session.gather() == []
        for got in (session.submit(plan).result(), session.run(plan),
                    *session.gather(session.submit(plan))):
            assert_results_match(got, want, 6)
    finally:
        session.scheduler().close()
    spilling = _mesh_session(catalog, device_budget=1 << 20)
    assert_results_match(spilling.execute(plan), want, 6)
    assert spilling.last_driver.ctx.spill is not None
    adaptive = _mesh_session(catalog, feedback=True)
    assert_results_match(adaptive.execute(plan), want, 6)
    assert len(adaptive.feedback_store()) > 0
    got = session.table("nation").collect(
        options=ExecutionOptions(feedback=True))
    assert len(got["n_nationkey"]) == 25


def test_mesh_session_device_and_worker_split():
    catalog = port_catalog(ref_dbgen.generate(sf=0.002))
    two = EngineMesh([CPU, CPU])
    with pytest.raises(ValueError, match="do not split evenly"):
        Session(catalog, device="cpu", num_workers=3, mesh=two)
    session = Session(catalog, device="cpu", num_workers=4, mesh=two)
    with pytest.raises(ValueError, match="do not split evenly"):
        session.table("nation").collect(
            options=ExecutionOptions(num_workers=3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(catalog, num_workers=4,
                    mesh=EngineMesh([torch.device("cuda", 0)]))


def test_bare_cuda_is_the_current_device_for_mesh_and_session(monkeypatch):
    # ``cuda`` without an index is resolved once, by one rule, for both
    # arguments: the current device, here a fake cuda:1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    mesh = EngineMesh(["cuda"])
    assert mesh.devices == [torch.device("cuda", 1)]
    catalog = port_catalog(ref_dbgen.generate(sf=0.002))
    session = Session(catalog, device="cuda", num_workers=4, mesh=mesh)
    assert session.device == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="not the mesh's first device"):
        Session(catalog, device="cuda:0", num_workers=4, mesh=mesh)


def test_scan_places_each_worker_on_its_device(data):
    catalog = port_catalog(data)
    src = catalog.get("nation")
    for steps in (src.scan(None, 8, "cpu", num_workers=4, mesh=_cpu_mesh()),
                  src.stream(None, 8, "cpu", num_workers=4,
                             mesh=_cpu_mesh())):
        got = [t.device for step in steps for t in step]
        assert got and set(got) == {CPU}


# ---------------------------------------------------------------------------
# every kernel launch under its tensors' device
# ---------------------------------------------------------------------------

def _function_calls(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "function"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "build"):
            yield node


_LAUNCH_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", [p for p in _LAUNCH_FILES
                                  if any(_function_calls(p))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_c_entry_call_names_its_device(path):
    for call in _function_calls(path):
        assert any(k.arg == "device" for k in call.keywords), (
            f"{path.relative_to(ROOT)}:{call.lineno} calls build.function "
            "without device=")
