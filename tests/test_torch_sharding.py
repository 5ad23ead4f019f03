"""The port's sharding policy (``repro_torch.models.sharding``) and model
mesh (``repro_torch.launch.mesh``) against the reference's
``repro.models.sharding`` and ``repro.launch.mesh``, on the CPU.

The reference's specs need no devices: ``param_spec`` is called on the
normalized paths of its own ``eval_shape`` pytrees (as its
``params_shardings`` calls it), and ``batch_shardings`` /
``cache_shardings`` run with ``jax.sharding.NamedSharding`` recorded by
``monkeypatch``. The port's trees are built on ``meta``. A leaf that the
reference stacks on a leading group axis is compared without that axis.
Specs compare exactly, a one-name tuple read as the name (JAX's own
normalization). ``shard_shape`` is held to JAX's ``NamedSharding`` on an
``AbstractMesh`` of the same shape.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs.base import SHAPES as RSHAPES  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import sharding as rshp  # noqa: E402
from repro.train.train_step import train_state_init as rstate_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch.mesh import (ModelMesh, axes_of,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import sharding as shp  # noqa: E402
from repro_torch.train import train_state_init  # noqa: E402

ARCHS = configs.ARCH_IDS
MESHES = {"16x16": False, "2x16x16": True}


def _norm(spec):
    """A spec as a tuple, a one-name tuple entry read as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _axes(mesh_name, zero_stage=3):
    """(port Axes, reference Axes) of a production mesh."""
    mine = dataclasses.replace(
        axes_of(make_production_mesh(multi_pod=MESHES[mesh_name])),
        zero_stage=zero_stage)
    ref = rshp.Axes(dp=mine.dp, tp=mine.tp, dp_size=mine.dp_size,
                    tp_size=mine.tp_size, zero_stage=zero_stage)
    return mine, ref


def _ref_path(port_path: str, period: int):
    """(the reference's normalized path of a port ``TrainState`` path,
    whether the reference stacks the leaf on a leading group axis)."""
    head, _, rest = port_path.partition(".")
    if head == "opt":
        field, _, rest = rest.partition(".")
        head = f"opt.{field}"
    if not rest:
        return f".{head}", False
    parts = rest.split(".")
    if parts[0] == "layers":
        i = int(parts[1])
        return f".{head}.blocks.pos{i % period}." + ".".join(parts[2:]), True
    if parts[0] in ("enc_layers", "dec_layers"):
        return f".{head}.{parts[0][:3]}_blocks." + ".".join(parts[2:]), True
    return f".{head}.{rest}", False


@pytest.fixture(scope="module")
def states():
    """arch -> (the port's TrainState on meta, the reference's
    eval_shape TrainState's leaves by normalized path)."""
    out = {}
    for arch in ARCHS:
        port = train_state_init(build_model(configs.get_config(arch),
                                            device="meta"))
        ref = jax.eval_shape(lambda a=arch: rstate_init(
            rbuild(rconfigs.get_config(a)), jax.random.key(0)))
        leaves = {}
        jax.tree_util.tree_map_with_path(
            lambda p, x: leaves.__setitem__(
                rshp._norm_path(jax.tree_util.keystr(p)), x), ref)
        out[arch] = (port, leaves)
    return out


@pytest.mark.parametrize("zero_stage", [1, 3])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(states, arch, mesh_name, zero_stage):
    """Every leaf of every config's full TrainState (parameters, both
    moments, the step): the reference's spec, less the group axis."""
    port, ref = states[arch]
    axes, raxes = _axes(mesh_name, zero_stage)
    period = configs.get_config(arch).block_period
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    placed = shp.params_shardings(port, axes, mesh)
    seen = set()

    def check(path, leaf, sharding):
        rpath, stacked = _ref_path(path, period)
        rshape = tuple(ref[rpath].shape)
        assert (rshape[1:] if stacked else rshape) == tuple(leaf.shape), path
        want = _norm(rshp.param_spec(rpath, rshape, raxes))
        if stacked:     # the reference never shards the group axis
            assert want[0] is None, rpath
            want = want[1:]
        assert _norm(sharding.spec) == want, (path, rpath)
        assert sharding.spec == shp.param_spec(path, tuple(leaf.shape),
                                               axes)
        seen.add(rpath)

    shp.tree_map(check, port, placed)
    assert seen == set(ref), sorted(set(ref) ^ seen)[:5]


def _record_named(monkeypatch):
    monkeypatch.setattr(jax.sharding, "NamedSharding",
                        lambda mesh, spec: _norm(spec))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_match_reference(arch, mesh_name,
                                                   monkeypatch):
    """Over each applicable shape's ``input_specs``, and over the decode
    shapes' ``cache_specs`` (a decoder LM's per-layer caches against the
    reference's group stacks, less the group axis)."""
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    axes, raxes = _axes(mesh_name)
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    model, rmodel = build_model(cfg, device="meta"), rbuild(rcfg)
    _record_named(monkeypatch)
    for shape_name in configs.applicable_shapes(cfg):
        shape, rshape = SHAPES[shape_name], RSHAPES[shape_name]
        specs = model.input_specs(shape)
        want = rshp.batch_shardings(rmodel.input_specs(rshape), raxes, None)
        got = shp.batch_shardings(specs, axes, mesh)
        assert set(got) == set(want)
        for k in want:
            assert _norm(got[k].spec) == want[k], (shape_name, k)
        if shape.kind != "decode":
            continue
        rcache = rshp.cache_shardings(rmodel.cache_specs(rshape),
                                      rshape.seq_len, raxes, None)
        caches = model.cache_specs(shape)
        groups = cfg.n_layers // cfg.block_period
        got = shp.cache_shardings(caches, shape.seq_len, axes, mesh,
                                  groups=groups)
        if model.is_encdec:
            pairs = [(got["self"].k, rcache["self"].k),
                     (got["self"].v, rcache["self"].v),
                     (got["cross_k"], rcache["cross_k"]),
                     (got["cross_v"], rcache["cross_v"])]
        else:
            pairs = []
            for i, layer in enumerate(got):
                mine = jax.tree.leaves(layer, is_leaf=lambda x: isinstance(
                    x, shp.NamedSharding))
                ref = jax.tree.leaves(
                    rcache[f"pos{i % cfg.block_period}"],
                    is_leaf=lambda x: isinstance(x, tuple) and not hasattr(
                        x, "_fields"))
                assert len(mine) == len(ref), (i, mine, ref)
                pairs += [(m, r[1:]) for m, r in zip(mine, ref)]
        assert pairs
        for mine, ref in pairs:
            assert _norm(mine.spec) == _norm(ref), (shape_name, mine, ref)


_ACT_CASES = (("tokens", (32, 128)), ("hidden", (32, 128, 64)),
              ("heads", (32, 128, 16, 8)), ("heads", (32, 128, 12, 8)),
              ("ffn", (32, 128, 256)), ("logits", (32, 128, 1024)),
              ("experts", (64, 128, 64)), ("experts", (12, 128, 64)),
              ("kv_cache", (128, 4096, 8, 64)), ("kv_cache", (1, 4096, 8, 64)),
              ("mamba_state", (32, 256, 16)), ("mamba_state", (1, 256, 16)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("role,shape", _ACT_CASES)
def test_act_spec_matches_shard_act(role, shape, mesh_name, monkeypatch):
    """The spec the reference's ``shard_act`` passes to ``_maybe`` (None
    where it passes none); the port's ``shard_act`` returns its input."""
    axes, raxes = _axes(mesh_name)
    seen = []
    monkeypatch.setattr(rshp, "_maybe", lambda x, spec: seen.append(spec))
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    with rshp.use_axes(raxes, None):
        rshp.shard_act(x, role)
    want = _norm(seen[0]) if seen else None
    got = shp.act_spec(shape, role, axes)
    assert (None if got is None else _norm(got)) == want
    t = torch.empty(shape, device="meta")
    assert shp.shard_act(t, role) is t
    with pytest.raises(ValueError):
        shp.shard_act(t, "nope")
    with pytest.raises(ValueError):
        shp.act_spec(shape, "nope", axes)


_SPECS = ((("data", "model"), (64, 32)), ((("pod", "data"), "model"),
                                          (64, 32, 5)),
          ((None, ("data", "model")), (3, 512)), ((), (7, 9)),
          (("model",), (48,)), ((("model", "data"), None), (256, 1)))


@pytest.mark.parametrize("spec,shape", _SPECS)
def test_shard_shape_matches_jax(spec, shape):
    """``shard_shape`` against JAX's on the 2x16x16 mesh, and the error
    where a dimension does not divide."""
    mesh = make_production_mesh(multi_pod=True)
    jmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    mine = shp.NamedSharding(mesh, shp.P(*spec))
    assert mine.shard_shape(shape) == tuple(
        JNamedSharding(jmesh, JP(*spec)).shard_shape(shape))
    bad = tuple(n + 1 if i < len(spec) and spec[i] else n
                for i, n in enumerate(shape))
    if bad != shape:
        with pytest.raises(ValueError):
            JNamedSharding(jmesh, JP(*spec)).shard_shape(bad)
        with pytest.raises(ValueError):
            mine.shard_shape(bad)


def test_device_put_shards_and_full():
    """Each position holds its own copy of its block (the first named axis
    the major), on its device; ``full`` and ``region`` assemble them."""
    cpu = torch.device("cpu")
    mesh = ModelMesh(np.array([cpu] * 8, dtype=object).reshape(2, 4),
                     ("data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    st = shp.device_put(x, shp.NamedSharding(mesh, shp.P(("data", "model"))))
    assert st.local((1, 2)).shape == (1, 12)
    assert torch.equal(st.local((1, 2)), x[6:7])
    ptrs = {st.local(p).data_ptr() for p in mesh.positions()}
    assert len(ptrs) == 8 and x.data_ptr() not in ptrs
    assert torch.equal(st.full(), x)
    rep = shp.device_put(x, shp.NamedSharding(mesh, shp.P(None, "model")))
    assert torch.equal(rep.local((0, 3)), rep.local((1, 3)))
    assert rep.local((0, 3)).data_ptr() != rep.local((1, 3)).data_ptr()
    assert torch.equal(rep.region((slice(2, 5), slice(1, 7)), (0, 0)),
                       x[2:5, 1:7])
    assert rep.region((slice(None), slice(3, 6)), (1, 1)) is rep.local((1, 1))
    assert torch.equal(shp.device_put(rep, st.sharding).full(), x)
    assert axes_of(mesh) == shp.Axes(dp=("data",), tp="model", dp_size=2,
                                     tp_size=4)
    assert make_production_mesh().size == 256
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
