"""``repro_torch.models.moe_a2a.moe_ffn_a2a`` across tp positions (a
policy active through ``models.sharding.use_axes`` on a
``launch.mesh.ModelMesh`` of CPU positions) against the port's local path
and the reference's ``shard_map`` path, at dbrx-132B's and
deepseek-moe-16B's SMOKE configs (the counterpart of
``tests/test_moe_dispatch.py::test_explicit_path_under_real_mesh``).

Tolerances are ``tests/test_torch_moe.py``'s: ``y`` within rtol = atol =
2e-2, ``aux`` within 1e-5 of the reference's. Against the port's own local
path on identical inputs the routing is the same, the outputs differ only
by the order of the bfloat16 adds of the combine (rtol = atol = 2e-2), and
``aux`` is within 1e-6. Against the reference's dp 2 x tp 2 run (4
forced host devices, in a subprocess) the port runs on the reference's
experts by the near-tie rule of ``tests/torch_routing.py`` (each dp
shard's router probabilities as the reference computes them, each of the
port's own choices that differs a near tie below ``MARGIN``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from torch_routing import Routed, forced  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import moe_a2a as ref_a2a  # noqa: E402
from repro.models import sharding as rshp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import ModelMesh, axes_of  # noqa: E402
from repro_torch.models import moe_a2a  # noqa: E402
from repro_torch.models import sharding as shp  # noqa: E402

MOE = ("dbrx_132b", "deepseek_moe_16b")
RTOL = ATOL = 2e-2
MARGIN = 1e-3
B, S = 4, 32
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a):
    a = np.asarray(a)
    dtype = torch.float32 if a.dtype == np.float32 else torch.bfloat16
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _setup(arch, seed):
    """(config, the reference's ``init_moe`` params, their torch copies,
    x as the reference's bfloat16 array and as a torch tensor)."""
    cfg = configs.get_config(arch, smoke=True)
    p = rmoe.init_moe(jax.random.key(seed),
                      rconfigs.get_config(arch, smoke=True))
    x = np.random.default_rng(seed + 1).normal(0, 1, (B, S, cfg.d_model))
    return (cfg, p, {k: _t(v) for k, v in p.items()},
            jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).bfloat16())


def _mesh(dp, tp):
    devs = np.empty((dp, tp), dtype=object)
    devs.fill(torch.device("cpu"))
    return ModelMesh(devs, ("data", "model"))


@pytest.mark.parametrize("arch", MOE)
def test_explicit_path_under_1x1_mesh(arch):
    """The tp path on a 1 x 1 mesh against the reference's output with
    the reference's weights (its own test holds its 1 x 1 ``shard_map``
    path to its local one)."""
    cfg, p, tp, rx, tx = _setup(arch, 0)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    raxes = rshp.Axes(dp=("data",), tp="model", dp_size=1, tp_size=1)
    with mesh, rshp.use_axes(raxes, mesh):
        want, raux = ref_a2a.moe_ffn_a2a(p, rx, cfg)
    pmesh = _mesh(1, 1)
    with shp.use_axes(axes_of(pmesh), pmesh):
        got, aux = moe_a2a.moe_ffn_a2a(tp, tx, cfg)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("placed", [False, True], ids=["whole", "sharded"])
@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch", MOE)
def test_tp_ranks_match_local_path(arch, dp, tp, placed):
    """tp 2 and 4 (and dp 2 x tp 2 over a batch dp does not split, B 1)
    against the port's local path; expert leaves whole or placed by
    ``params_shardings`` (each rank's local shard, dp-sharded dimensions
    gathered); the all-reduce's counted bytes."""
    cfg, _, params, _, x = _setup(arch, 2)
    if dp > 1:
        x = x[:1]           # B 1 < dp: every dp row runs the same tokens
    want, waux = moe_a2a.moe_ffn_a2a(params, x, cfg)
    mesh = _mesh(dp, tp)
    axes = axes_of(mesh)
    if placed:
        shardings = shp.params_shardings(params, axes, mesh)
        params = {k: shp.device_put(v, shardings[k])
                  for k, v in params.items()}
        assert params["experts_w1"].local((0, 0)).shape[0] == \
            cfg.n_experts // tp
    with shp.use_axes(axes, mesh):
        got, aux = moe_a2a.moe_ffn_a2a(params, x, cfg)
        counts = roofline.count_program(moe_a2a.moe_ffn_a2a, params, x, cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    ar = counts["kernels"]["moe_a2a.all_reduce"]
    n = x.shape[0] * S * cfg.d_model * 2
    assert ar["calls"] == 1 and ar["collective_bytes"] == dp * tp * n
    assert counts["collective_bytes"] == dp * tp * n


_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import moe, moe_a2a
from repro.models.sharding import Axes, use_axes
arch, seed, b, s, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4]), sys.argv[5]
cfg = get_config(arch, smoke=True)
p = moe.init_moe(jax.random.key(seed), cfg)
x = jnp.asarray(np.random.default_rng(seed + 1).normal(0, 1, (b, s, cfg.d_model)),
                jnp.bfloat16)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
axes = Axes(dp=("data",), tp="model", dp_size=2, tp_size=2)
with mesh, use_axes(axes, mesh):
    y, aux = jax.jit(lambda p, x: moe_a2a.moe_ffn_a2a(p, x, cfg))(p, x)
probs = [jax.nn.softmax(xs.reshape(-1, cfg.d_model).astype(jnp.float32)
                        @ p["router"], axis=-1) for xs in (x[:b // 2], x[b // 2:])]
np.savez(out, y=np.asarray(y, np.float32), aux=np.asarray(aux),
         probs=np.stack([np.asarray(q) for q in probs]),
         **{k: np.asarray(v, np.float32) for k, v in p.items()})
print("REF_OK", len(jax.devices()))
"""


@pytest.mark.parametrize("arch", MOE)
def test_dp2_tp2_matches_reference_shard_map(arch, tmp_path):
    """dp 2 x tp 2 against the reference's ``shard_map`` path on a 2 x 2
    mesh of 4 forced host devices: each dp shard's capacity from its own
    tokens, aux the first dp shard's (the reference's replicated output
    takes it)."""
    out = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, arch, "4",
                           str(B), str(S), out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "REF_OK 4" in proc.stdout
    ref = np.load(out)
    cfg, _, params, _, x = _setup(arch, 4)
    for k, v in params.items():     # the subprocess drew the same weights
        assert np.array_equal(_np(v), ref[k]), k
    mesh = _mesh(2, 2)
    rec = Routed(cfg.top_k, [ref["probs"][i] for i in (0, 0, 1, 1)])
    with shp.use_axes(axes_of(mesh), mesh), forced(rec):
        got, aux = moe_a2a.moe_ffn_a2a(params, x, cfg)
    rec.check(MARGIN, f"{arch} dp 2 x tp 2")
    np.testing.assert_allclose(_np(got), ref["y"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(ref["aux"]), rtol=1e-5)
    print(json.dumps({"arch": arch, "routing": rec.summary(MARGIN)}))
