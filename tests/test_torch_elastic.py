"""``repro_torch.runtime.elastic`` on CPU meshes (the counterpart of
``tests/test_runtime.py::test_elastic_reshard_roundtrip``): a qwen2 SMOKE
``TrainState`` resharded across (1, 1), (2, 2) and (1, 4) layouts of
``launch.mesh.ModelMesh`` and back, every leaf bit-equal at every step and
each position's shard the block the policy gives it; ``restore_for_mesh``
of a ``CheckpointManager`` checkpoint likewise. The reference's own
``reshard_state`` on its 1 x 1 mesh gives the same values as the port's
from the same state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.runtime.elastic import reshard_state as ref_reshard  # noqa: E402
from repro.train.train_step import train_state_init as rstate_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.mesh import ModelMesh, axes_of  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import sharding as shp  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402
from repro_torch.runtime.elastic import (reshard_state,  # noqa: E402
                                         restore_for_mesh)
from repro_torch.train import train_state_init  # noqa: E402

LAYOUTS = ((1, 1), (2, 2), (1, 4), (1, 1))


def _mesh(dp, tp):
    devs = np.empty((dp, tp), dtype=object)
    devs.fill(torch.device("cpu"))
    return ModelMesh(devs, ("data", "model"))


@pytest.fixture(scope="module")
def state():
    """qwen2's SMOKE TrainState with random moments and step 7."""
    model = build_model(configs.get_config("qwen2_1_5b", smoke=True),
                        device="cpu")
    st = train_state_init(model)
    gen = torch.Generator().manual_seed(5)
    m = {k: torch.randn(v.shape, generator=gen) for k, v in st.opt.m.items()}
    v = {k: torch.rand(x.shape, generator=gen) for k, x in st.opt.v.items()}
    return st._replace(opt=st.opt._replace(
        step=torch.tensor(7, dtype=torch.int32), m=m, v=v))


def _check_placed(placed, want, mesh):
    """Every leaf a ShardedTensor on ``mesh`` by the policy's spec, its
    whole bit-equal to ``want``'s, each position's shard its block."""
    shardings = shp.params_shardings(want, axes_of(mesh), mesh)

    def one(path, got, ref, sh):
        assert isinstance(got, shp.ShardedTensor), path
        assert got.sharding.spec == sh.spec and got.mesh is mesh, path
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert torch.equal(got.full(), ref), path
        for pos in mesh.positions():
            assert torch.equal(got.local(pos),
                               ref[sh.index(pos, tuple(ref.shape))]), path

    shp.tree_map(one, placed, want, shardings)


def test_elastic_reshard_roundtrip(state):
    """(1, 1) -> (2, 2) -> (1, 4) -> (1, 1), each step from the last
    placement, bit-equal throughout; (2, 2) and (1, 4) split the
    embedding and the projections (ZeRO-3 and tp)."""
    cur = state
    for dp, tp in LAYOUTS:
        mesh = _mesh(dp, tp)
        cur = reshard_state(cur, mesh)
        _check_placed(cur, state, mesh)
        if tp == 4:
            assert cur.params["embed"].local((0, 0)).shape[0] == \
                state.params["embed"].shape[0] // 4
        if dp == 2:
            wq = [k for k in state.params if k.endswith("mixer.wq")][0]
            assert cur.opt.m[wq].sharding.spec == shp.P("data", "model")


def test_restore_for_mesh(state, tmp_path):
    """A checkpoint written by ``CheckpointManager`` restored onto (2, 2)
    and onto (1, 4) from a placed template; none -> (None, None, None)."""
    assert restore_for_mesh(str(tmp_path), state, _mesh(2, 2)) == (
        None, None, None)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, state, {"note": "x"})
    template = reshard_state(state, _mesh(1, 4))
    for dp, tp in ((2, 2), (1, 4)):
        mesh = _mesh(dp, tp)
        step, placed, extra = restore_for_mesh(str(tmp_path), template, mesh)
        assert step == 7 and extra == {"note": "x"}
        _check_placed(placed, state, mesh)


def test_reshard_matches_reference_on_1x1():
    """The reference's ``reshard_state`` on its 1 x 1 mesh and the port's
    on (1, 1) and (2, 2), from the same state: every leaf equal."""
    rmodel = rbuild(rconfigs.get_config("qwen2_1_5b", smoke=True))
    rstate = rstate_init(rmodel, jax.random.key(3))
    model = build_model(configs.get_config("qwen2_1_5b", smoke=True),
                        device="cpu")
    mine = train_state_from_reference(model, rstate)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    want = train_state_from_reference(model, ref_reshard(rstate, mesh))
    for dp, tp in ((1, 1), (2, 2)):
        pmesh = _mesh(dp, tp)
        _check_placed(reshard_state(mine, pmesh), want, pmesh)
