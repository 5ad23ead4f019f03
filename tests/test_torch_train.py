"""The port's training (``repro_torch.train``) against the reference
``repro.train`` on the CPU: the optimizer, one train step carried across
from a mid-training state, the gradient compression, and the engine's
query feeding training.

Tolerances, with the largest errors seen:
- ``lr_schedule``, ``global_norm`` and ``adamw_update`` on float32 trees:
  within 1e-6 relative (``RTOL_OPT``), each element against ``RTOL_OPT``
  times its tensor's largest |value|; seen 2.4e-7.
- One train step at qwen2's SMOKE config (B 4, S 32, base lr 1e-2) from
  step 150 (past warmup), the reference's weights and a seeded ``m``, ``v``
  carried across by ``models.convert.train_state_from_reference``, at 1 and
  2 microbatches: the gradients are bfloat16 in both engines and differ by
  their rounding (1-2% of each leaf's largest |gradient|), so the loss
  within ``RTOL_LOSS`` = 1e-4 (seen 1.6e-5), ``grad_norm`` within
  ``RTOL_GNORM`` = 1e-3 (seen 1.2e-4), ``m`` and ``v`` within
  ``MOMENT_TOL`` = 5e-2 of each leaf's largest |value| (seen 1.5e-2 and
  2.4e-2), and each parameter within one bfloat16 ulp of its value plus
  ``PARAM_LR_TOL`` = 0.3 learning rates (seen 0.13).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.train import compression as rcomp  # noqa: E402
from repro.train import make_train_step as rmake_train_step  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import train_state_init as rtrain_state_init  # noqa: E402
from repro.train.train_step import TrainState as RTrainState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dtypes as dt  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.core.session import Catalog, Session  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (reference_leaf,  # noqa: E402
                                        train_state_from_reference)
from repro_torch.train import compression, optimizer  # noqa: E402
from repro_torch.train import make_train_step, train_state_init  # noqa: E402

RTOL_OPT = 1e-6
RTOL_LOSS = 1e-4
RTOL_GNORM = 1e-3
MOMENT_TOL = 5e-2
PARAM_LR_TOL = 0.3
B, S, BASE_LR, MID_STEP = 4, 32, 1e-2, 150


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and torch's threads a process would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol, what):
    """Each element within ``rtol`` times the tensor's largest |value|."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, np.float32)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rtol * scale, f"{what}: max error {err:.3g} of {scale:.3g}"


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 100, 10_000),
                                                  (1e-2, 10, 50)])
def test_lr_schedule_matches_reference(base_lr, warmup, total):
    steps = np.array([0, 1, 5, 9, 10, 11, 25, 49, 50, 99, 100, 101, 150,
                      5000, 9999, 10_000, 20_000], np.int32)
    want = ropt.lr_schedule(jnp.asarray(steps), base_lr, warmup, total)
    got = optimizer.lr_schedule(torch.from_numpy(steps), base_lr, warmup,
                                total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_OPT,
                               atol=0)


def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, scale, s).astype(np.float32)
            for k, s in shapes.items()}


_SHAPES = {"a": (64, 32), "b": (32,), "c": (3, 5, 7), "d": ()}


def test_global_norm_matches_reference():
    tree = _tree(0, _SHAPES)
    want = ropt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = optimizer.global_norm({k: _t(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_OPT)


@pytest.mark.parametrize("step", [0, MID_STEP])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])   # clip off / on
def test_adamw_update_matches_reference(step, grad_scale):
    params, grads = _tree(1, _SHAPES), _tree(2, _SHAPES, grad_scale)
    m = _tree(3, _SHAPES, 1e-3)
    v = {k: (x ** 2 + 1e-8).astype(np.float32)
         for k, x in _tree(4, _SHAPES, 1e-3).items()}
    rstate = ropt.AdamWState(jnp.int32(step),
                             {k: jnp.asarray(x) for k, x in m.items()},
                             {k: jnp.asarray(x) for k, x in v.items()})
    rp, rs, rinfo = ropt.adamw_update(
        {k: jnp.asarray(x) for k, x in params.items()},
        {k: jnp.asarray(x) for k, x in grads.items()}, rstate,
        base_lr=1e-2, total_steps=500)
    state = optimizer.AdamWState(torch.tensor(step, dtype=torch.int32),
                                 {k: _t(x) for k, x in m.items()},
                                 {k: _t(x) for k, x in v.items()})
    tp = {k: _t(x) for k, x in params.items()}
    p, s, info = optimizer.adamw_update(
        tp, {k: _t(x) for k, x in grads.items()}, state, base_lr=1e-2,
        total_steps=500)
    assert int(s.step) == int(rs.step) == step + 1
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(info[key]), float(rinfo[key]),
                                   rtol=RTOL_OPT)
    for k in _SHAPES:
        _close(p[k], rp[k], RTOL_OPT, f"param {k}")
        _close(s.m[k], rs.m[k], RTOL_OPT, f"m {k}")
        _close(s.v[k], rs.v[k], RTOL_OPT, f"v {k}")
        # functional: the inputs are as they were
        assert np.array_equal(tp[k].numpy(), params[k])
        assert np.array_equal(state.m[k].numpy(), m[k])


def test_adamw_keeps_float32_moments_and_casts_once():
    """bfloat16 parameters: float32 moments, and the float32 update of the
    float32 view of each parameter rounded once to bfloat16."""
    params = {k: _t(x).bfloat16() for k, x in _tree(5, _SHAPES).items()}
    grads = {k: _t(x).bfloat16() for k, x in _tree(6, _SHAPES, 1e-2).items()}
    state = optimizer.adamw_init(params)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert all(x.dtype == torch.float32 for x in state.m.values())
    f32 = optimizer.adamw_update({k: x.float() for k, x in params.items()},
                                 grads, state, base_lr=1e-2)
    p, s, _ = optimizer.adamw_update(params, grads, state, base_lr=1e-2)
    for k in params:
        assert p[k].dtype == torch.bfloat16
        assert s.m[k].dtype == s.v[k].dtype == torch.float32
        assert torch.equal(p[k], f32[0][k].bfloat16())
        assert torch.equal(s.m[k], f32[1].m[k])


# ---------------------------------------------------------------------------
# one train step, carried across from a mid-training state
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's model, a state at MID_STEP (seeded m, and v with
    sqrt(v) of the order of |m|) and a batch."""
    model = rbuild(rconfigs.get_config("qwen2_1_5b", smoke=True))
    state = rtrain_state_init(model, jax.random.key(0))
    rng = np.random.default_rng(7)
    m = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1e-3, p.shape), jnp.float32), state.params)
    v = jax.tree.map(lambda p: jnp.asarray(
        1e-6 * rng.uniform(0.5, 1.5, p.shape), jnp.float32), state.params)
    state = RTrainState(state.params,
                        ropt.AdamWState(jnp.int32(MID_STEP), m, v))
    tok = rng.integers(0, model.cfg.vocab, (B, S + 1), dtype=np.int32)
    return model, state, tok


@functools.lru_cache(maxsize=None)
def _ref_step(microbatches):
    model, state, tok = _ref()
    step = jax.jit(rmake_train_step(model, microbatches=microbatches,
                                    base_lr=BASE_LR))
    return step(state, {"tokens": jnp.asarray(tok[:, :-1]),
                        "labels": jnp.asarray(tok[:, 1:])})


def _ulp_bf16(x):
    """One bfloat16 ulp of each |x| (2^-7 of its power of two)."""
    a = np.maximum(np.abs(x), 1e-30)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    rmodel, rstate, tok = _ref()
    port = build_model(get_config("qwen2_1_5b", smoke=True), device="cpu")
    state = train_state_from_reference(port, rstate)
    before = {k: v.clone() for k, v in state.params.items()}
    batch = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    new, metrics = make_train_step(port, microbatches=microbatches,
                                   base_lr=BASE_LR)(state, batch)
    rnew, rmetrics = _ref_step(microbatches)
    assert int(new.opt.step) == MID_STEP + 1
    np.testing.assert_allclose(float(metrics["loss"]), float(rmetrics["loss"]),
                               rtol=RTOL_LOSS)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(rmetrics["grad_norm"]), rtol=RTOL_GNORM)
    np.testing.assert_allclose(float(metrics["lr"]), float(rmetrics["lr"]),
                               rtol=RTOL_OPT)
    lr = float(rmetrics["lr"])
    period = port.cfg.block_period
    moved = 0
    for name, p in new.params.items():
        assert p.dtype == before[name].dtype
        assert torch.equal(state.params[name], before[name])   # functional
        want = np.asarray(reference_leaf(rnew.params, name, period),
                          np.float32)
        err = np.abs(p.float().numpy() - want)
        assert (err <= PARAM_LR_TOL * lr + _ulp_bf16(want)).all(), (
            f"{name}: max error {err.max():.3g}, lr {lr:.3g}")
        moved += int((p != before[name]).sum())
        for what, tree, got in (("m", rnew.opt.m, new.opt.m),
                                ("v", rnew.opt.v, new.opt.v)):
            assert got[name].dtype == torch.float32
            _close(got[name], reference_leaf(tree, name, period), MOMENT_TOL,
                   f"{what} {name}")
    assert moved > 0.9 * sum(p.numel() for p in new.params.values())


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

_GRADS = {"w": (256, 64), "b": (64,), "z": (8,)}


def _grads(seed, scale=1.0):
    g = _tree(seed, _GRADS, scale)
    g["z"] = np.zeros(8, np.float32)          # all-zero: the 1e-12 floor
    g["b"][3] = 127.5 * np.abs(g["b"]).max() / 127.0   # a tie to round
    return g


def test_quantize_is_bit_exact():
    for k, g in _grads(0).items():
        q, s = compression.quantize(_t(g))
        rq, rs = rcomp.quantize(jnp.asarray(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(rq)), k
        assert s.numpy().tobytes() == np.asarray(rs).tobytes(), k
        np.testing.assert_array_equal(
            compression.dequantize(q, s).numpy(),
            np.asarray(rcomp.dequantize(rq, rs)))


def test_compress_tree_is_bit_exact():
    g, e = _grads(1), _tree(2, _GRADS, 1e-3)
    q, s, err = compression.compress_tree({k: _t(x) for k, x in g.items()},
                                          {k: _t(x) for k, x in e.items()})
    rq, rs, rerr = rcomp.compress_tree({k: jnp.asarray(x) for k, x in g.items()},
                                       {k: jnp.asarray(x) for k, x in e.items()})
    for k in _GRADS:
        assert np.array_equal(q[k].numpy(), np.asarray(rq[k]))
        assert s[k].numpy().tobytes() == np.asarray(rs[k]).tobytes()
        assert err[k].numpy().tobytes() == np.asarray(rerr[k]).tobytes()
    zero = compression.ef_init({k: _t(x) for k, x in g.items()})
    assert all(z.dtype == torch.float32 and not z.any() for z in zero.values())


def test_error_feedback_is_unbiased_over_steps():
    """With error feedback the sum of what was sent converges to the sum of
    the true gradients (the reference's test, on the port)."""
    true = _t(np.random.default_rng(1).normal(0, 1e-3, (128,)))
    err = torch.zeros_like(true)
    sent = torch.zeros_like(true)
    for _ in range(50):
        q, s, err = compression.compress_tree(true, err)
        sent = sent + compression.dequantize(q, s)
    np.testing.assert_allclose(sent.numpy(), true.numpy() * 50, rtol=0.05,
                               atol=1e-4)


@pytest.mark.parametrize("workers", [1, 4])
def test_allreduce_compressed_matches_psum_formula(workers):
    """The W workers' compressed mean equals the reference's psum/pmax
    formula on its own quantize: sum the int8 payloads as int32, take the
    largest scale, dequantize, divide by W; each worker's new error is its
    own."""
    grads = [_grads(10 + w, scale=w + 1.0) for w in range(workers)]
    errs = [_tree(20 + w, _GRADS, 1e-2) for w in range(workers)]
    outs, new_errs = compression.allreduce_compressed(
        [{k: _t(x) for k, x in g.items()} for g in grads],
        [{k: _t(x) for k, x in e.items()} for e in errs])
    ref = [rcomp.compress_tree({k: jnp.asarray(x) for k, x in g.items()},
                               {k: jnp.asarray(x) for k, x in e.items()})
           for g, e in zip(grads, errs)]
    for k in _GRADS:
        total = sum(np.asarray(q[k]).astype(np.int32) for q, _, _ in ref)
        smax = jnp.max(jnp.stack([s[k] for _, s, _ in ref]))
        want = np.asarray(rcomp.dequantize(jnp.asarray(total), smax) / workers)
        for w in range(workers):
            assert outs[w][k].numpy().tobytes() == want.tobytes(), (k, w)
            assert (new_errs[w][k].numpy().tobytes()
                    == np.asarray(ref[w][2][k]).tobytes())
    assert compression.compressed_bytes(outs[0]) * 3.5 < \
        compression.raw_bytes(outs[0])


def test_wire_bytes_equal_reference():
    g = {k: jnp.asarray(x) for k, x in _grads(3).items()}
    tg = {k: _t(x) for k, x in _grads(3).items()}
    assert compression.compressed_bytes(tg) == rcomp.compressed_bytes(g)
    assert compression.raw_bytes(tg) == rcomp.raw_bytes(g)
    assert compression.raw_bytes(tg["w"]) == rcomp.raw_bytes(g["w"])


# ---------------------------------------------------------------------------
# the engine feeding training (tests/test_system.py's, on the port)
# ---------------------------------------------------------------------------

def test_engine_feeds_training_data():
    """Filter a token table with a query of the port's engine, train on the
    result: the loss decreases over 16 steps."""
    rng = np.random.default_rng(0)
    corpus = {"doc": np.repeat(np.arange(200), 50).astype(np.int32),
              # skewed tokens: a uniform draw has nothing to learn
              "tok": (rng.random(10_000) ** 4 * 512).astype(np.int32),
              "quality": rng.random(10_000).astype(np.float32)}
    catalog = Catalog()
    catalog.register_numpy("corpus", corpus, {"doc": dt.INT32, "tok": dt.INT32,
                                              "quality": dt.FLOAT32})
    plan = P.Project(P.Filter(P.TableScan("corpus"), col("quality") > 0.2),
                     [("tok", col("tok"))])
    tokens = Session(catalog, device="cpu", num_workers=2,
                     batch_rows=4096).execute(plan)["tok"]
    want = corpus["tok"][corpus["quality"] > np.float32(0.2)]
    np.testing.assert_array_equal(np.sort(tokens), np.sort(want))

    model = build_model(get_config("qwen2_1_5b", smoke=True), device="cpu")
    state = train_state_init(model)
    step = make_train_step(model, base_lr=1e-2)
    pipe = TokenPipeline(tokens, batch=2, seq_len=32, device="cpu")
    losses = []
    for _ in range(16):
        state, m = step(state, next(pipe))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
