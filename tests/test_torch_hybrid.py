"""The port's Mamba (``repro_torch.models.mamba``) and the ``hybrid``
family (jamba-v0.1's SMOKE config: 8 layers, attention at layer 3, Mamba
elsewhere, MoE on the odd layers) against the reference ``repro.models``
on the CPU: the reference's weights carried across by
``models.convert.load_reference``, the same numpy inputs through both.

The reference's ``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's
``F.softplus`` returns x past 20, where the two differ below float32's
resolution. Their bfloat16 ``silu`` rounds differently too, so about three
quarters of a Mamba layer's bfloat16 outputs differ by an ulp.

An output is a sum over a row of inputs that differ by an ulp, so its
error follows the size of its row: ``_rows`` holds each element within
``tol`` plus ``tol`` times its row's largest |value| (the K/V caches'
rule in ``tests/test_torch_lm_model.py``). Tolerances, with the largest
errors seen:
- ``mamba_forward`` at S 64 and 128 (the reference's chunks need S // (S
  // 64) to divide S), ``mamba_decode`` from a random state and the
  prefill's output and conv window: ``_rows`` within 2e-2 (seen 0.039 at
  a row of |y| 4.1); the rolled part of the window equal; the ssm state
  (decode, and the prefill's against the reference's
  ``_mamba_tail_state``) within 2e-2 of its largest |value|.
- The port's forward at S 129 (which the reference's reshape refuses):
  its first 128 rows equal to its forward at S 128, the last within
  ``_rows``' 2e-2 of its decode step.
- The model (B 2, S 32, 4 decode steps) on the reference's routing
  (``tests/torch_lm_routing.py``): each choice of the port's own that
  differs is a near tie, its gap below ``MARGIN`` = 1e-2 on the router
  probabilities of 4 experts (seen 3.9e-3, in the forward; the
  probabilities drift by up to 0.0092 from the reference's, and a flip's
  gap is at most twice the drift). Logits, K, V and conv windows by ``_rows`` within
  ``LM_TOL`` = 8e-2 (seven Mamba layers' ulps add up: the needed tol
  seen 0.042 in layer 3's K after the prefill, 0.026 in the logits, and
  0.0605 in layer 3's K after 4 decode steps, where the port's decode
  rounds its conv as its forward does and the reference's sums the
  window by an einsum); each ssm state within ``SSM_TOL`` = 0.1 of its
  largest |value| (its B and dt are bfloat16 products, one ulp 0.4-0.8%:
  seen 0.010 after layer 0, 0.069 after layer 7 and 4 decode steps); aux
  within 1e-4 (seen 1.5e-5); the loss within 2e-3.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_lm_routing import models, routed  # noqa: E402
from torch_routing import decode_on_forward_routing  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import mamba as rmb  # noqa: E402
from repro.models.model import synthetic_batch as rsynthetic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks, build_model, mamba  # noqa: E402
from repro_torch.models.model import synthetic_batch  # noqa: E402

ARCH = "jamba_v0_1_52b"
RTOL = ATOL = 2e-2
LM_TOL = 8e-2
SSM_TOL = 0.1
MARGIN = 1e-2
B, S, STEPS = 2, 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and torch's threads a process would oversubscribe
    them (as ``tests/test_torch_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _mamba_params(seed):
    """(config, the reference's ``init_mamba`` params, torch copies)."""
    cfg = configs.get_config(ARCH, smoke=True)
    p = rmb.init_mamba(jax.random.key(seed),
                       rconfigs.get_config(ARCH, smoke=True))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in p.items()}
    return cfg, p, tp


def _x(cfg, s, seed):
    x = np.random.default_rng(seed).normal(0, 1, (B, s, cfg.d_model))
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).bfloat16())


def _rows(got, want, tol, what):
    """Each element within ``tol`` plus ``tol`` times the largest |value|
    of its row (the last axis): an output is a sum over a row of inputs
    that differ by an ulp, so its error follows the row's size."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w)
    row = np.abs(w).max(axis=-1, keepdims=True)
    assert (err <= tol + tol * row).all(), (
        f"{what}: max error {err.max():.4g}, needs tol "
        f"{(err / (1 + row)).max():.4g}")


def _within(got, want, rel, what):
    """Each element within ``rel`` times the largest |want|."""
    g, w = _np(got), _np(want)
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), f"{what}: {err:.3g}"


# -- the module ---------------------------------------------------------------

def test_init_mamba_matches_reference():
    cfg, p, _ = _mamba_params(0)
    mine = mamba.init_mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    assert list(mine) == list(p)
    for k, v in p.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype)[6:] == str(v.dtype), k
    for k in ("conv_b", "dt_bias", "a_log", "d_skip"):
        assert np.array_equal(_np(mine[k]), _np(p[k])), k
    assert (mamba.d_inner(cfg), mamba.dt_rank(cfg)) == (
        rmb.d_inner(cfg), rmb.dt_rank(cfg))


@pytest.mark.parametrize("s", [64, 128])
def test_mamba_forward_matches_reference(s):
    cfg, p, tp = _mamba_params(1)
    rx, tx = _x(cfg, s, 2)
    want = rmb.mamba_forward(p, rx, cfg)
    got = mamba.mamba_forward(tp, tx, cfg)
    assert got.shape == (B, s, cfg.d_model) and got.dtype == torch.bfloat16
    _rows(got, want, RTOL, f"mamba_forward S {s}")


def test_mamba_forward_takes_any_s():
    """S 129, which the reference's reshape into chunks refuses (2 chunks
    of 64): the first 128 rows equal the port's forward at S 128, and the
    last one its decode step from that prefill's state."""
    cfg, p, tp = _mamba_params(3)
    rx, tx = _x(cfg, 129, 4)
    with pytest.raises(TypeError):
        rmb.mamba_forward(p, rx, cfg)
    got = mamba.mamba_forward(tp, tx, cfg)
    head, state = blocks._mamba_prefill(tp, tx[:, :128], cfg)
    assert torch.equal(got[:, :128], head)
    last, _ = mamba.mamba_decode(tp, tx[:, 128:], cfg, state)
    _rows(got[:, 128:], last, RTOL, "S 129's last row against decode")


def test_mamba_decode_matches_reference():
    """One step from a random state: the output, the rolled conv window
    (equal) and the ssm state."""
    cfg, p, tp = _mamba_params(5)
    rx, tx = _x(cfg, 1, 6)
    rng = np.random.default_rng(7)
    conv = rng.normal(0, 1, (B, cfg.mamba_d_conv - 1, mamba.d_inner(cfg)))
    ssm = rng.normal(0, 1, (B, mamba.d_inner(cfg), cfg.mamba_d_state))
    want, rstate = rmb.mamba_decode(p, rx, cfg, rmb.MambaState(
        jnp.asarray(conv, jnp.bfloat16), jnp.asarray(ssm, jnp.float32)))
    got, state = mamba.mamba_decode(tp, tx, cfg, mamba.MambaState(
        torch.from_numpy(conv.astype(np.float32)).bfloat16(),
        torch.from_numpy(ssm.astype(np.float32))))
    _rows(got, want, RTOL, "mamba_decode")
    assert state.conv.dtype == torch.bfloat16
    assert state.ssm.dtype == torch.float32
    assert np.array_equal(_np(state.conv[:, :-1]), _np(rstate.conv[:, :-1]))
    _rows(state.conv, rstate.conv, RTOL, "conv window")
    _within(state.ssm, rstate.ssm, RTOL, "ssm state")


@pytest.mark.parametrize("s", [64, 128])
def test_prefill_state_matches_tail_state(s):
    """The final state of the forward's own loop against the reference's
    ``_mamba_tail_state``, which reruns the scan; the window equal to the
    reference's last d_conv - 1 pre-conv rows."""
    cfg, p, tp = _mamba_params(8)
    rx, tx = _x(cfg, s, 9)
    want, rstate = rblocks._mamba_prefill(p, rx, cfg)
    got, state = blocks._mamba_prefill(tp, tx, cfg)
    _rows(got, want, RTOL, "prefill output")
    _rows(state.conv, rstate.conv, RTOL, "conv window")
    assert state.conv.shape == (B, cfg.mamba_d_conv - 1, mamba.d_inner(cfg))
    _within(state.ssm, rstate.ssm, RTOL, "final ssm state")
    tail = rblocks._mamba_tail_state(
        p, jnp.split(rx @ p["in_proj"], 2, axis=-1)[0], cfg)
    assert np.array_equal(_np(tail), _np(rstate.ssm))


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_prefill_then_decode(s):
    """A prompt shorter than the conv window's d_conv - 1 rows: the
    prefill's window holds zero rows before the prompt, as the forward's
    conv pads, so the prefill and 4 decode steps give the forward's rows
    over the s + 4 tokens: the port's and the reference's (one chunk of
    s + 4), by ``_rows`` within 2e-2."""
    cfg, p, tp = _mamba_params(10)
    rx, tx = _x(cfg, s + 4, 11)
    head, state = blocks._mamba_prefill(tp, tx[:, :s], cfg)
    assert state.conv.shape == (B, cfg.mamba_d_conv - 1, mamba.d_inner(cfg))
    outs = [head]
    for t in range(s, s + 4):
        y, state = mamba.mamba_decode(tp, tx[:, t:t + 1], cfg, state)
        outs.append(y)
    got = torch.cat(outs, dim=1)
    _rows(got, mamba.mamba_forward(tp, tx, cfg), RTOL,
          f"prompt of {s} and 4 steps against the port's forward")
    _rows(got, rmb.mamba_forward(p, rx, cfg), RTOL,
          f"prompt of {s} and 4 steps against the reference's forward")


# -- the model ----------------------------------------------------------------

def _close(got, want, what):
    _rows(got, want, LM_TOL, what)


def _tokens(cfg, s, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, s),
                                               dtype=np.int32)
    return {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}


def _cache_close(got, want, i, what):
    """Layer i's cache against the reference's stacked one: K, V and a
    Mamba state's conv window by ``_rows`` within ``LM_TOL``, its ssm
    state within ``SSM_TOL`` of its largest |value|."""
    ref = want[f"pos{i % 8}"]
    if isinstance(got, mamba.MambaState):
        _rows(got.conv, ref.conv[i // 8], LM_TOL, f"{what} conv window")
        _within(got.ssm, ref.ssm[i // 8], SSM_TOL, f"{what} ssm state")
        return
    _rows(got.k, ref.k[i // 8], LM_TOL, f"{what} K")
    _rows(got.v, ref.v[i // 8], LM_TOL, f"{what} V")


@functools.lru_cache(maxsize=None)
def _serve():
    """Prefill of S then STEPS decode steps on both (the reference's
    greedy tokens, the port on the reference's routing): [((reference
    logits, caches), (port logits, caches)) a step], and the port's
    prefill's attention calls."""
    ref, params, port = models(ARCH)
    rb, tb = _tokens(port.cfg, S, 0)
    calls = []
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(a) or real(*a, **k)
    try:
        with routed(port.cfg.top_k) as rec:
            rl, rc = jax.jit(ref.prefill, static_argnums=2)(params, rb,
                                                            S + STEPS)
            tl, tc = port.prefill(tb, S + STEPS)
    finally:
        ops.flash_attention = real
    rec.check(MARGIN, "prefill")
    steps = [((rl, rc), (tl, [type(c)(*(t.clone() for t in c))
                              for c in tc]))]
    decode = jax.jit(ref.decode_step)
    for t in range(STEPS):
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        with routed(port.cfg.top_k) as rec:
            rl, rc = decode(params, jnp.asarray(nxt), rc, jnp.int32(S + t))
            tl, tc = port.decode_step(torch.from_numpy(nxt), tc, S + t)
        rec.check(MARGIN, f"decode step {t}")
        steps.append(((rl, rc), (tl, tc)))
    return steps, len(calls)


def test_forward_logits():
    ref, params, port = models(ARCH)
    rb, tb = _tokens(port.cfg, S, 1)
    with routed(port.cfg.top_k) as rec:
        want, raux = jax.jit(ref.forward)(params, rb)
        with torch.no_grad():
            got, aux = port.forward(tb)
    rec.check(MARGIN, "forward")
    assert got.shape == (B, S, port.cfg.vocab) and got.dtype == torch.bfloat16
    _close(got, want, "forward")
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-4)


def test_prefill_logits_and_caches():
    steps, launches = _serve()
    (rl, rc), (tl, tc) = steps[0]
    cfg = configs.get_config(ARCH, smoke=True)
    assert launches == 1                    # the one attention layer
    _close(tl, rl, "prefill logits")
    kinds = [type(c).__name__ for c in tc]
    assert kinds == ["MambaState"] * 3 + ["KVCache"] + ["MambaState"] * 4
    for i, c in enumerate(tc):
        _cache_close(c, rc, i, f"layer {i} cache")
    assert not tc[3].k[:, S:].any()
    assert tc[0].ssm.dtype == torch.float32 and tc[0].ssm.shape == (
        B, mamba.d_inner(cfg), cfg.mamba_d_state)


def test_decode_steps():
    steps, _ = _serve()
    for t, ((rl, rc), (tl, tc)) in enumerate(steps[1:]):
        _close(tl, rl, f"decode step {t}")
    for i, c in enumerate(tc):
        _cache_close(c, rc, i, f"layer {i} cache after decode")


def test_loss_matches_reference():
    ref, params, port = models(ARCH)
    shape = configs.ShapeSpec("smoke_train", 16, 2, "train")
    with routed(port.cfg.top_k) as rec:
        want = jax.jit(ref.loss)(params, rsynthetic(ref, rconfigs.ShapeSpec(
            "smoke_train", 16, 2, "train")))
        with torch.no_grad():
            got = port.loss(synthetic_batch(port, shape))
    rec.check(MARGIN, "loss")
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3)


def test_load_reference_carries_mamba_leaves():
    """Every parameter equals the reference's leaf, read through the
    period-8 stacking (layer i is ``pos{i % 8}``, group ``i // 8``);
    ``a_log``, ``dt_bias`` and ``d_skip`` stay float32."""
    ref, params, port = models(ARCH)
    names = dict(port.named_parameters())
    for k in ("a_log", "dt_bias", "d_skip"):
        assert names[f"layers.5.mixer.{k}"].dtype == torch.float32
    assert "layers.3.mixer.wq" in names and "layers.3.ffn.router" in names
    for name, p in names.items():
        if not name.startswith("layers."):
            continue
        parts = name.split(".")
        node = params["blocks"][f"pos{int(parts[1]) % 8}"]
        for key in parts[2:]:
            node = node[key]
        assert np.array_equal(_np(p.detach()), _np(node[int(parts[1]) // 8]))


# -- tests/test_arch_smoke.py's four, on the port -----------------------------

SMOKE_SHAPE = configs.ShapeSpec("smoke_train", 64, 2, "train")


def test_forward_shapes_and_finite():
    model = build_model(configs.get_config(ARCH, smoke=True), device="cpu")
    with torch.no_grad():
        logits, aux = model.forward(synthetic_batch(model, SMOKE_SHAPE))
    assert logits.shape == (2, 64, model.cfg.vocab)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(aux)


def test_train_step_reduces_loss_and_finite_grads():
    """The reference's plain SGD nudge (w - 0.3 g) on one batch."""
    model = build_model(configs.get_config(ARCH, smoke=True), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    batch = synthetic_batch(model, SMOKE_SHAPE)
    loss0 = model.loss(batch)
    grads = torch.autograd.grad(loss0, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p -= 0.3 * g.to(p.dtype)
        loss1 = model.loss(batch)
    assert float(loss1) < float(loss0.detach())


def test_prefill_decode_consistent_with_forward():
    """Decode from empty caches, one token at a time, on the forward's
    routing, reproduces the last position of ``forward`` within rtol =
    atol = 0.15 (the reference's)."""
    model = build_model(configs.get_config(ARCH, smoke=True), device="cpu",
                        generator=torch.Generator().manual_seed(2))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 32), dtype=np.int32))
    full, logits, rec = decode_on_forward_routing(model, tok)
    rec.check(MARGIN, "decode against forward")
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, -1]),
                               rtol=0.15, atol=0.15)


def test_param_count_full_config_matches_family():
    cfg = configs.get_config(ARCH)
    assert 45e9 <= cfg.param_count() <= 60e9
    meta = build_model(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    ref = jax.eval_shape(lambda: rbuild(rconfigs.get_config(ARCH)).init(
        jax.random.key(0)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
