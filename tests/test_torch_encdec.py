"""The port's encoder-decoder (``repro_torch.models.encdec``, the
``encdec`` family: seamless-m4t-large-v2's SMOKE config, 2 encoder and 2
decoder layers, d_model 64, 4 heads of 16) against the reference
``repro.models`` on the CPU: the reference's weights carried across by
``models.convert.load_reference``, the same numpy inputs through both. The
reference's outputs are computed once a module (``functools.lru_cache``).

The prefill's encoder runs its self-attention through
``kernels.ops.flash_attention`` (its plain version here) without the
causal mask, at any number of frames T; ``forward``'s encoder is plain
torch. Tolerances, with the largest errors seen (bfloat16 throughout; the
two engines round in other places, about one ulp an op):
- ``cross_attention``, the encoder's output at T 32 and a ragged T 200
  (128 does not divide it; the reference takes any T), ``forward``'s
  logits, the prefill's cross K and V, each decode step's logits and self
  cache: each element within ``RTOL`` = 2e-2 plus 2e-2 times its row's
  largest |value| (``_rows``; the largest need 0.013 of it, the encoder at
  T 200 and the self K, max |diff| 0.047 on rows up to 3.6; the logits
  0.0054). The encoder's two paths are equal here. The loss within 2e-3.
- A training step (B 2, 32 frames, 16 tokens, base lr 1e-2, from step
  150): the loss within 2e-3, grad_norm within 2e-2, ``m`` within 5e-2 of
  each leaf's largest |value| (seen 0.0096, ``lm_head``), each parameter
  within one bfloat16 ulp plus 0.3 learning rates
  (``tests/test_torch_train.py``'s limits).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import encdec as red  # noqa: E402
from repro.models.model import synthetic_batch as rsynthetic  # noqa: E402
from repro.train import make_train_step as rmake_train_step  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import train_state_init as rtrain_state_init  # noqa: E402
from repro.train.train_step import TrainState as RTrainState  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, build_model, encdec  # noqa: E402
from repro_torch.models.convert import (load_reference,  # noqa: E402
                                        reference_leaf,
                                        train_state_from_reference)
from repro_torch.models.model import synthetic_batch  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ARCH = "seamless_m4t_large_v2"
RTOL = 2e-2
B, T, S, STEPS = 2, 40, 8, 4
BASE_LR, MID_STEP = 1e-2, 150
PARAM_LR_TOL, MOMENT_TOL = 0.3, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores (as ``tests/test_torch_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rows(got, want, tol, what):
    """Each element within ``tol`` plus ``tol`` times the largest |value|
    of its row (the last axis)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w)
    row = np.abs(w).max(axis=-1, keepdims=True)
    assert (err <= tol + tol * row).all(), (
        f"{what}: max error {err.max():.4g}, needs tol "
        f"{(err / (1 + row)).max():.4g}")


def _within(got, want, rel, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), f"{what}: {err:.3g}"


@functools.lru_cache(maxsize=None)
def _models():
    """(reference model, its params, the port's CPU model with them)."""
    ref = rbuild(rconfigs.get_config(ARCH, smoke=True))
    params = ref.init(jax.random.key(0))
    port = build_model(configs.get_config(ARCH, smoke=True), device="cpu")
    load_reference(port, params)
    return ref, params, port


def _frames(t, seed):
    x = np.random.default_rng(seed).normal(0, 1, (B, t, 64))
    return jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()


def _tokens(s, seed):
    tok = np.random.default_rng(seed).integers(0, 512, (B, s), dtype=np.int32)
    return jnp.asarray(tok), torch.from_numpy(tok)


# -- the layers ------------------------------------------------------------------

def test_cross_attention_matches_reference():
    """S 8 queries against T 40 memory rows, no mask, no RoPE."""
    ref, params, port = _models()
    p = jax.tree.map(lambda a: a[0], params["dec_blocks"]["cross"])
    rx, tx = _frames(S, 1)
    rm, tm = _frames(T, 2)
    want = rattn.cross_attention(p, rx, rm, ref.cfg)
    got = attention.cross_attention(port.dec_layers[0].cross, tx, tm,
                                    port.cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, 64)
    _rows(got, want, RTOL, "cross_attention")


@pytest.mark.parametrize("t", [32, 200])
def test_encode_matches_reference(t):
    """``encode`` plain (the train path) and through ``ops
    .flash_attention`` without the causal mask (the prefill: one call a
    layer at T itself, no padding), against the reference's ``encode``."""
    ref, params, port = _models()
    rf, tf = _frames(t, 3 + t)
    want = jax.jit(red.encode, static_argnums=1)(params, ref.cfg, rf)
    calls = []
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append((a, k)) or real(*a,
                                                                       **k)
    try:
        with torch.no_grad():
            plain = encdec.encode(port, port.cfg, tf)
            flash = encdec.encode(port, port.cfg, tf, flash=True)
    finally:
        ops.flash_attention = real
    assert len(calls) == port.cfg.n_enc_layers
    for (q, k, v), kw in calls:
        assert q.shape == (B, 4, t, 16) and kw == {"causal": False}
    _rows(plain, want, RTOL, f"encode T {t}")
    _rows(flash, want, RTOL, f"encode T {t} through the kernel's path")
    _rows(flash, plain, RTOL, f"encode T {t}: the two paths")


# -- the model -------------------------------------------------------------------

def test_forward_logits_and_loss():
    ref, params, port = _models()
    rf, tf = _frames(T, 4)
    rt, tt = _tokens(S, 5)
    want, _ = jax.jit(ref.forward)(params, {"frames": rf, "tokens": rt})
    with torch.no_grad():
        got, aux = port.forward({"frames": tf, "tokens": tt})
    assert got.shape == (B, S, 512) and got.dtype == torch.bfloat16
    assert float(aux) == 0.0
    _rows(got, want, RTOL, "forward")
    shape = configs.ShapeSpec("smoke_train", 64, B, "train")
    rb = rsynthetic(ref, rconfigs.ShapeSpec("smoke_train", 64, B, "train"))
    tb = synthetic_batch(port, shape)
    assert list(tb) == ["frames", "tokens", "labels"]
    assert tb["tokens"].shape == (B, 16)
    for k in rb:
        assert np.array_equal(_np(tb[k]), _np(rb[k])), k
    with torch.no_grad():
        loss = port.loss(tb)
    np.testing.assert_allclose(float(loss), float(jax.jit(ref.loss)(
        params, rb)), rtol=2e-3)


def _serve(ref, params, port, t, steps, seed):
    """The prefill of ``t`` frames, then ``steps`` decode steps fed drawn
    tokens on both: [(reference logits, caches), (port logits, caches)]
    a step, the prefill's first (logits None), and the port's prefill's
    launch counts."""
    rf, tf = _frames(t, seed)
    rt, tt = _tokens(steps, seed + 1)
    rc = jax.jit(ref.prefill)(params, {"frames": rf})
    ops.reset_launch_counts()
    tc = port.prefill({"frames": tf})
    counts = ops.launch_counts()
    out = [((None, rc), (None, {k: (type(v)(*(x.clone() for x in v))
                                    if k == "self" else v.clone())
                                for k, v in tc.items()}))]
    decode = jax.jit(ref.decode_step)
    for i in range(steps):
        rl, rc = decode(params, rt[:, i:i + 1], rc, jnp.int32(i))
        tl, tc = port.decode_step(tt[:, i:i + 1], tc, i)
        out.append(((rl, rc), (tl, tc)))
    return out, counts


@functools.lru_cache(maxsize=None)
def _served():
    ref, params, port = _models()
    return _serve(ref, params, port, T, STEPS, 6)


def test_prefill_caches():
    """Cross K and V of every decoder layer ``[L, B, T, K, dh]``, the self
    caches zero over ``SELF_BUFFER`` positions; no kernel launch on the
    CPU."""
    (((_, rc), (_, tc)),), counts = _served()[0][:1], _served()[1]
    assert sum(counts.values()) == 0
    assert tc["cross_k"].shape == (2, B, T, 4, 16)
    assert tc["self"].k.shape == (2, B, encdec.SELF_BUFFER, 4, 16)
    assert not tc["self"].k.any() and not tc["self"].v.any()
    for k in ("cross_k", "cross_v"):
        _rows(tc[k], rc[k], RTOL, k)


def test_decode_steps():
    """Each step's logits, and the self caches after the last step."""
    steps = _served()[0]
    for i, ((rl, _), (tl, _)) in enumerate(steps[1:]):
        assert tl.shape == (B, 1, 512)
        _rows(tl, rl, RTOL, f"decode step {i}")
    (_, rc), (_, tc) = steps[-1]
    _rows(tc["self"].k[:, :, :STEPS], rc["self"].k[:, :, :STEPS], RTOL,
          "self K")
    _rows(tc["self"].v[:, :, :STEPS], rc["self"].v[:, :, :STEPS], RTOL,
          "self V")
    assert not tc["self"].k[:, :, STEPS:].any()


def test_self_buffer_clamps_pos(monkeypatch):
    """``SELF_BUFFER`` set to 8 in both engines, 12 decode steps: from step
    8 on, each writes the last slot and attends over the whole buffer with
    RoPE at position 7, as the reference's clamp does."""
    ref, params, port = _models()
    monkeypatch.setattr(red, "SELF_BUFFER", 8)
    monkeypatch.setattr(encdec, "SELF_BUFFER", 8)
    steps, _ = _serve(ref, params, port, 24, 12, 8)
    for i, ((rl, _), (tl, _)) in enumerate(steps[1:]):
        _rows(tl, rl, RTOL, f"decode step {i} of a buffer of 8")
    (_, rc), (_, tc) = steps[-1]
    assert tc["self"].k.shape[2] == 8
    _rows(tc["self"].k, rc["self"].k, RTOL, "self K")


def test_load_reference_carries_stacked_leaves():
    """Every parameter equals the reference's ``enc_blocks`` or
    ``dec_blocks`` row (one layer a row) or top-level leaf; every leaf of
    the reference is covered, row by row."""
    _, params, port = _models()
    names = dict(port.named_parameters())
    assert sum(p.numel() for p in names.values()) == sum(
        x.size for x in jax.tree.leaves(params))
    assert len(names) == sum(x.shape[0] if "_blocks" in str(path) else 1
                             for path, x in jax.tree_util.tree_leaves_with_path(
                                 params))
    assert {"embed", "final_norm", "enc_norm", "lm_head",
            "enc_layers.1.mixer.wq", "dec_layers.1.ln_x",
            "dec_layers.0.cross.wv"} <= set(names)
    for name, p in names.items():
        want = np.asarray(reference_leaf(params, name, 1), np.float32)
        assert np.array_equal(_np(p), want), name
    leaf = reference_leaf(params, "dec_layers.1.cross.wk", 1)
    assert np.array_equal(np.asarray(leaf, np.float32), np.asarray(
        params["dec_blocks"]["cross"]["wk"][1], np.float32))


def test_init_caches_refused_and_specs():
    """An encoder-decoder's caches come from ``prefill``; its input specs
    at a train shape: frames [B, S, D], tokens and labels of max(S // 4,
    16)."""
    _, _, port = _models()
    with pytest.raises(ValueError, match="prefill"):
        port.init_caches(B, 16)
    specs = port.input_specs(configs.ShapeSpec("t", 128, B, "train"))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "frames": (B, 128, 64), "tokens": (B, 32), "labels": (B, 32)}


def test_train_step_matches_reference():
    """One AdamW step from step 150 (seeded m and v), B 2, 32 frames and
    16 tokens, through ``make_train_step`` unchanged."""
    ref, params, port = _models()
    state = rtrain_state_init(ref, jax.random.key(0))
    rng = np.random.default_rng(7)
    m = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1e-3, p.shape), jnp.float32), state.params)
    v = jax.tree.map(lambda p: jnp.asarray(
        1e-6 * rng.uniform(0.5, 1.5, p.shape), jnp.float32), state.params)
    state = RTrainState(state.params, ropt.AdamWState(jnp.int32(MID_STEP),
                                                      m, v))
    rb = rsynthetic(ref, rconfigs.ShapeSpec("t", 32, B, "train"), seed=3)
    rnew, rmet = jax.jit(rmake_train_step(ref, base_lr=BASE_LR))(state, rb)
    model = build_model(port.cfg, device="cpu")
    tstate = train_state_from_reference(model, state)
    new, met = make_train_step(model, base_lr=BASE_LR)(
        tstate, synthetic_batch(model, configs.ShapeSpec("t", 32, B, "train"),
                                seed=3))
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=2e-2)
    lr = float(rmet["lr"])
    for name, p in new.params.items():
        want = np.asarray(reference_leaf(rnew.params, name, 1), np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        err = np.abs(_np(p) - want)
        assert (err <= PARAM_LR_TOL * lr + ulp).all(), (
            f"{name}: max error {err.max():.3g}, lr {lr:.3g}")
        _within(new.opt.m[name], reference_leaf(rnew.opt.m, name, 1),
                MOMENT_TOL, f"m {name}")


def test_param_count_full_config():
    cfg = configs.get_config(ARCH)
    meta = build_model(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    ref = jax.eval_shape(lambda: rbuild(rconfigs.get_config(ARCH)).init(
        jax.random.key(0)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    assert 1.2e9 <= n <= 3.0e9
