"""Out-of-core execution on a mesh session (``Session(mesh=...,
device_budget=...)``) against the reference's one-device mesh session
(``torch_diff.ref_mesh_session``, its ``jnp`` backend), the oracle and the
port's own runs off the mesh, on the CPU at SF 0.002 with 8192-row morsels.

* Q3, Q5 and Q18 at W = 4 under a 16 KiB device budget: equal to the
  reference's mesh run under the same budget and to the oracle.
* The spill counters (``executor_stats()["spill"]``): at W = 1, field for
  field the reference's mesh session's; at W = 4, those of the port's run
  off the mesh whose exchange lays rows out as the mesh does, and those of
  a two-device mesh; Q3's also those of the fused exchange off the mesh.
  (A broadcast on a mesh hands each worker the W source tables end to end,
  the reference's mesh layout, where the fused exchange off the mesh hands
  it one table of the live rows: a join build fed by a broadcast then
  reserves other bytes, and Q5's and Q18's grace joins split otherwise.)
* The scheduler's over-budget query on a mesh runs under a spill plan.
* The grace join's parts across devices: ``_grace_pids`` counts one
  histogram call a device and adds the counts on the host;
  ``SpillManager.spill_step`` keeps each worker table's device and
  ``restore_step`` gives each back there; a grace join over the step of an
  ``EngineMesh([cpu, cpu])`` equals the reference's worker-stacked one
  (``test_torch_out_of_core.py::
  test_grace_hash_join_stacked_workers_match_reference``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_out_of_core import (_both, _column_names,  # noqa: E402
                                    _drive, _grace_pair, _rows, _sides)
from torch_diff import (DIST_SF, port_catalog, port_mesh_session,  # noqa: E402
                        ref_mesh_session)
from tpch_util import assert_results_match  # noqa: E402

from repro.core.table import DeviceTable  # noqa: E402
from repro.kernels import ops as ref_kernel_ops  # noqa: E402
from repro.tpch import dbgen as ref_dbgen  # noqa: E402
from repro.tpch import oracle  # noqa: E402
from repro.tpch import queries as ref_queries  # noqa: E402
from repro_torch import ICIExchange, SchedulerConfig  # noqa: E402
from repro_torch.core import dtypes as dt  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.spill import SpillManager  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.launch.mesh import EngineMesh  # noqa: E402
from repro_torch.tpch import queries  # noqa: E402

QUERIES = (3, 5, 18)
BUDGET = 16 * 1024
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    return ref_dbgen.generate(sf=DIST_SF)


@pytest.fixture(scope="module")
def catalog(data):
    return port_catalog(data)


@pytest.fixture(scope="module")
def ref_catalog():
    return ref_dbgen.load_catalog(sf=DIST_SF)


def _spill(session, plan):
    out = session.execute(plan)
    return out, session.executor_stats()["spill"]


@pytest.mark.parametrize("q", QUERIES)
def test_tiny_budget_on_a_mesh_equals_reference_and_oracle(
        q, data, catalog, ref_catalog):
    ref = ref_mesh_session(ref_catalog, 4, device_budget=BUDGET)
    want = ref.execute(ref_queries.build_query(q, ref_catalog,
                                               num_workers=4))
    session = port_mesh_session(catalog, 4, device_budget=BUDGET)
    got, spill = _spill(session, queries.build_query(q, catalog,
                                                     num_workers=4))
    assert_results_match(got, want, q)
    assert_results_match(got, oracle.ORACLES[q](data), q)
    assert spill["spilled_bytes"] > 0
    assert session.executor_stats()["worker_devices"] == ["cpu"] * 4
    assert session.last_driver.ctx.spill.host.in_use == 0


@pytest.mark.parametrize("q", QUERIES)
def test_spill_counters_at_one_worker_equal_reference(q, catalog,
                                                      ref_catalog):
    ref = ref_mesh_session(ref_catalog, 1, device_budget=BUDGET)
    ref.execute(ref_queries.build_query(q, ref_catalog))
    _, got = _spill(port_mesh_session(catalog, 1, device_budget=BUDGET),
                    queries.build_query(q, catalog))
    assert got == ref.executor_stats()["spill"]
    assert got["spilled_bytes"] > 0


@pytest.mark.parametrize("q", QUERIES)
def test_spill_counters_at_four_workers_equal_off_mesh(q, catalog):
    plan = queries.build_query(q, catalog, num_workers=4)
    _, on = _spill(port_mesh_session(catalog, 4, device_budget=BUDGET), plan)
    _, on2 = _spill(port_mesh_session(catalog, 4, devices=2,
                                      device_budget=BUDGET), plan)
    same_layout = Session(catalog, device="cpu", batch_rows=8192,
                          num_workers=4, device_budget=BUDGET,
                          exchange=ICIExchange(mesh=EngineMesh([CPU])))
    _, off = _spill(same_layout, plan)
    assert on == on2 == off
    assert on["spilled_bytes"] > 0


def test_q3_spill_counters_at_four_workers_equal_the_fused_exchange(catalog):
    plan = queries.build_query(3, catalog, num_workers=4)
    _, on = _spill(port_mesh_session(catalog, 4, device_budget=BUDGET), plan)
    _, off = _spill(Session(catalog, device="cpu", batch_rows=8192,
                            num_workers=4, device_budget=BUDGET), plan)
    assert on == off and on["spilled_bytes"] > 0


def test_scheduler_runs_an_over_budget_query_out_of_core_on_a_mesh(
        data, catalog):
    session = port_mesh_session(catalog, 4)
    plan = queries.build_query(18, catalog, num_workers=4)
    session.scheduler_config = SchedulerConfig(memory_budget=BUDGET,
                                               cache_results=False)
    try:
        handle = session.submit(plan)
        got = handle.result(timeout=120)
        stats = session.scheduler().stats()
    finally:
        session.scheduler().close()
    assert stats["spill_admitted"] == 1 and handle.spill_plan is not None
    assert handle.executor_stats["spill"]["spilled_bytes"] > 0
    assert_results_match(got, oracle.ORACLES[18](data), 18)


# ---------------------------------------------------------------------------
# the grace join's parts across devices
# ---------------------------------------------------------------------------

class _OnDevice(TorchTable):
    """A CPU table that reports ``cpu:<index>`` as its device: the workers
    of a mesh of several devices, on one CPU."""

    def __init__(self, table: TorchTable, index: int):
        super().__init__(table.columns, table.validity, table.schema)
        self._index = index

    @property
    def device(self) -> torch.device:
        return torch.device("cpu", self._index)


def _step(w, cap, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(w):
        data = {"k": rng.integers(-50, 50, cap).astype(np.int32),
                "bf": rng.normal(size=cap).astype(np.float32)}
        out.append(TorchTable.from_numpy(
            data, {"k": dt.INT32, "bf": dt.FLOAT32},
            device="cpu").filter(torch.from_numpy(rng.random(cap) < 0.8)))
    return out


def test_grace_pids_counts_one_call_a_device(monkeypatch):
    step = _step(4, 1000, seed=3)
    want_pids, want = ops._grace_pids(step, ("k",), 8)
    calls = []
    hist = ops.radix_histogram

    def counted(ids, bins):
        calls.append(bins)
        return hist(ids, bins)

    monkeypatch.setattr(ops, "radix_histogram", counted)
    two = [_OnDevice(t, i // 2) for i, t in enumerate(step)]
    pids, counts = ops._grace_pids(two, ("k",), 8)
    assert calls == [32, 32]                 # W * P bins on each device
    assert torch.equal(counts, want)
    for a, b in zip(pids, want_pids):
        assert torch.equal(a, b)


def test_spill_step_gives_each_table_back_to_its_device():
    step = [_OnDevice(t, i) for i, t in enumerate(_step(2, 64, seed=4))]
    mgr = SpillManager(0, device="cpu")
    nbytes = mgr.spill_step("p", step)
    assert nbytes == sum(t.nbytes() for t in step)
    assert mgr._host_store["p"].devices == (torch.device("cpu", 0),
                                            torch.device("cpu", 1))
    back = mgr.restore_step("p")
    assert len(back) == 2 and mgr.host.in_use == 0
    for got, want in zip(back, step):
        assert torch.equal(got.validity, want.validity)
        for n in want.columns:
            assert torch.equal(got.columns[n], want.columns[n])
    assert mgr.stats.host.spills == mgr.stats.host.restores == 1


def test_grace_hash_join_over_a_two_device_mesh_step_matches_reference():
    mesh = EngineMesh([CPU, CPU])
    w = 2
    devices = mesh.worker_devices(w)
    build, bvalid, probe, pvalid = _sides(dup=True, seed=9)
    halves = [_both({c: v[i * 300:(i + 1) * 300] for c, v in build.items()},
                    bvalid[i * 300:(i + 1) * 300], 512) for i in range(w)]
    probes = [_both({c: v[i * 600:(i + 1) * 600] for c, v in probe.items()},
                    pvalid[i * 600:(i + 1) * 600], 1024) for i in range(w)]

    def stacked(parts, names):
        return DeviceTable({n: jnp.stack([h[0].columns[n] for h in parts])
                            for n in names},
                           jnp.stack([h[0].validity for h in parts]),
                           dict(parts[0][0].schema))

    rb, rp = stacked(halves, build), stacked(probes, probe)
    pb = [h[1] for h in halves]
    pp = [h[1] for h in probes]
    assert [t.device for t in pb + pp] == devices * 2
    want_op, got_op, ref_mgr, port_mgr = _grace_pair(
        ("k",), ("bi", "bf"), "inner", 3, rb.nbytes() // 4, 600)
    with ref_kernel_ops.use_backend("jnp"):
        want = _drive(want_op, rb, [rp])
    got = _drive(got_op, pb, [pp])
    assert got_op.num_partitions == want_op.num_partitions == 8
    names = _column_names(want[0])
    for i in range(w):
        assert all(step[i].device == devices[i] for step in got)
        want_i = [DeviceTable({n: a[i] for n, a in t.columns.items()},
                              t.validity[i], t.schema) for t in want]
        assert _rows([step[i] for step in got], names) == _rows(want_i, names)
    assert port_mgr.stats.summary() == ref_mgr.stats.summary()
