"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch::

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_diff import (SEEDED_SCHEMA, assert_tables_equal,  # noqa: E402
                        seeded_columns, stage_cases)

from repro_torch.core import fused  # noqa: E402
from repro_torch.core.expr import col, date_lit, lit  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.table import TorchTable  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import segmented_agg as seg  # noqa: E402
from repro_torch.tpch import dbgen, queries  # noqa: E402

pytestmark = pytest.mark.gpu
_CASES = stage_cases(col, lit, date_lit)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,g", [(1 << 20, 16), (100_000, 9000), (0, 8)])
def test_segmented_kernels_on_card(cuda, n, g):
    rng = np.random.default_rng(n + g)
    gids = torch.from_numpy(np.sort(rng.integers(0, g + 1, n)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    ivals = torch.from_numpy(rng.integers(1 << 29, 1 << 30, n).astype(np.int32))
    ops.reset_launch_counts()
    got = seg.segmented_sum(gids.to(cuda), vals.to(cuda), g).cpu()
    igot = seg.segmented_int_sum(gids.to(cuda), ivals.to(cuda), g).cpu()
    assert ops.launch_counts()["segmented_sum"] == (1 if n else 0)
    np.testing.assert_array_equal(
        igot.numpy(), seg.segmented_int_sum_plain(gids, ivals, g).numpy())
    # float sums in another order: within 1e-4 of the group's sum of |v|
    want = seg.segmented_sum_plain(gids, vals, g).numpy()
    scale = seg.segmented_sum_plain(gids, vals.abs(), g).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 1e-4 * scale + 1e-6)


def test_segmented_kernels_reject_wrong_inputs(cuda):
    gids = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        seg.segmented_sum(gids, torch.ones(8, device=cuda), 4)
    with pytest.raises(ValueError):
        seg.segmented_int_sum(gids.int(), torch.ones(8, dtype=torch.int32), 4)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_kernel_on_card(cuda, case):
    data = seeded_columns(5000, seed=11)
    host = TorchTable.from_numpy(data, SEEDED_SCHEMA, device="cpu")
    host = host.filter(torch.from_numpy(np.arange(5000) % 7 != 3))
    want = fused.apply_stages(host, _CASES[case])
    dev = TorchTable({n: a.to(cuda) for n, a in host.columns.items()},
                     host.validity.to(cuda), host.schema)
    ops.reset_launch_counts()
    got, _, _ = fused.fused_morsel_program(dev, _CASES[case])
    assert ops.launch_counts()["fused_morsel_program"] == 1
    got = TorchTable({n: a.cpu() for n, a in got.columns.items()},
                     got.validity.cpu(), got.schema)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("q", [6, 1])
def test_query_on_card_matches_cpu(cuda, q):
    catalog = dbgen.load_catalog(sf=0.01)
    plan = queries.QUERIES[q](catalog)
    want = Session(catalog, device="cpu").execute(plan)
    ops.reset_launch_counts()
    session = Session(catalog)                 # device=None: the card
    got = session.execute(plan)
    assert ops.launch_counts()["fused_morsel_program"] == 8
    assert session.executor_stats()["kernel_dispatch"] == (
        {"fused": 8} if q == 6 else {"fused": 8, "agg": 15})
    for c, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=2e-3)
        else:
            np.testing.assert_array_equal(got[c], w)
