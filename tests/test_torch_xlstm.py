"""The port's xLSTM (``repro_torch.models.xlstm``) and the ``ssm`` family
(xlstm-125M's SMOKE config: 4 layers, mLSTM at 0-2, sLSTM at 3, no
channel) against the reference ``repro.models`` on the CPU: the
reference's weights carried across by ``models.convert.load_reference``,
the same numpy inputs through both. The reference's outputs are computed
once a module (``functools.lru_cache``).

Tolerances, with the largest errors seen:
- ``_mlstm_step``, ``_mlstm_recurrent`` and ``_mlstm_chunkwise`` on float32
  inputs at S 64 and 128, and the chunkwise-to-decode handoff: within the
  reference's own 2e-4 (``F32_TOL``; seen 1.7e-4 for the chunkwise h
  against the reference's, 6e-5 for the recurrent).
- ``mlstm_forward`` and ``slstm_forward`` in bfloat16 and each layer of the
  model fed the reference's own residual stream: each element within
  ``RTOL`` = 2e-2 plus 2e-2 times its row's largest |value| (``_rows``;
  about one bfloat16 ulp is seen); the sLSTM state within 2e-2 of each
  tensor's largest |value|.
- A ragged S (100, 129), which the reference refuses (its chunkwise form
  asserts that 64 divides S, its sLSTM's reshape fails): the port's
  chunkwise form against its own recurrent form within ``F32_TOL``; the
  sLSTM's rows and state against the same input at S 128 and a decode step
  (equal, and within ``_rows``' 2e-2).
- The whole model (B 2, S 32, prefill and 4 decode steps): the two engines
  round bfloat16 in other places (about one ulp a layer, above), and the
  exponential gates and sLSTM's ``c / n`` carry those ulps on: the
  residual stream's difference grows from 0.016 after layer 0 to 0.087
  after the sLSTM at S 64, on a row whose RMS is 0.33 (the final norm
  scales it up three times). Logits by ``_rows`` within ``LM_TOL`` = 0.15
  (the reference's own decode-against-forward tolerance; max |diff| 0.079
  at S 64, 0.050 of ``_rows``' scale), each state tensor within
  ``STATE_TOL`` = 0.1 of its largest |value| (seen 0.043, the sLSTM's
  after decode); the loss within 2e-3.
- A training step (B 2, S 32, base lr 1e-2, from step 150): the loss
  within 2e-3 (seen 9e-5), grad_norm within 2e-2 (seen 5.5e-3), ``m``
  within ``MOMENT_TOL`` = 5e-2 of each leaf's largest |value| (seen 0.027,
  the embedding), each parameter within one bfloat16 ulp plus
  ``PARAM_LR_TOL`` = 1.0 learning rates: the tied embedding's gradient
  adds the lookup's bfloat16 scatter (a repeated token's rows in another
  order) to the head's, seen 0.57 lr on 2e-4 of its entries; every other
  leaf within 0.1 lr.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import xlstm as rxl  # noqa: E402
from repro.models.model import synthetic_batch as rsynthetic  # noqa: E402
from repro.train import make_train_step as rmake_train_step  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import train_state_init as rtrain_state_init  # noqa: E402
from repro.train.train_step import TrainState as RTrainState  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import blocks, build_model, xlstm  # noqa: E402
from repro_torch.models.convert import (load_reference,  # noqa: E402
                                        reference_leaf,
                                        train_state_from_reference)
from repro_torch.models.model import synthetic_batch  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ARCH = "xlstm_125m"
F32_TOL = 2e-4
RTOL = 2e-2
LM_TOL = 0.15
STATE_TOL = 0.1
PARAM_LR_TOL = 1.0
MOMENT_TOL = 5e-2
B, S, STEPS = 2, 32, 4
BASE_LR, MID_STEP = 1e-2, 150


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
    """Each element within ``rel`` times the largest |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max(), f"{what}: {err:.3g}"


def _cfgs():
    return rconfigs.get_config(ARCH, smoke=True), \
        configs.get_config(ARCH, smoke=True)


def _params(init, seed):
    """(the reference's params of ``init``, torch copies in their dtypes)."""
    p = init(jax.random.key(seed), _cfgs()[0])
    return p, {k: _t(v).to(torch.float32 if v.dtype == jnp.float32
                             else torch.bfloat16) for k, v in p.items()}


def _x(s, seed, d=None):
    d = d or _cfgs()[0].d_model
    x = np.random.default_rng(seed).normal(0, 1, (B, s, d))
    return jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()


def _gates(s, seed, nh=2, dh=16):
    """float32 q, k, v [B, S, NH, DH], ig, fg [B, S, NH] (the forget gate
    around 2, as the reference's test draws it): (jax, torch)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, (B, s, nh, dh)) for _ in range(3)] + [
        rng.normal(0, 1, (B, s, nh)), rng.normal(2, 1, (B, s, nh))]
    return ([jnp.asarray(a, jnp.float32) for a in arrs],
            [_t(a) for a in arrs])


def _zero_state(nh=2, dh=16):
    return (rxl.MLSTMState(jnp.zeros((B, nh, dh, dh)), jnp.zeros((B, nh, dh)),
                           jnp.full((B, nh), -1e30)),
            xlstm.MLSTMState(torch.zeros(B, nh, dh, dh),
                             torch.zeros(B, nh, dh),
                             torch.full((B, nh), -1e30)))


# -- the modules ---------------------------------------------------------------

def test_init_matches_reference():
    """Keys, shapes and dtypes of ``init_mlstm`` and ``init_slstm`` (the
    gates and the whole sLSTM float32), the zero bias and the states."""
    rcfg, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    for rinit, init in ((rxl.init_mlstm, xlstm.init_mlstm),
                        (rxl.init_slstm, xlstm.init_slstm)):
        want = rinit(jax.random.key(0), rcfg)
        got = init(cfg, gen, "cpu")
        assert list(got) == list(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            assert str(got[k].dtype)[6:] == str(v.dtype), k
    assert not xlstm.init_slstm(cfg, gen, "cpu")["bias"].any()
    for rinit, init in ((rxl.init_mlstm_state, xlstm.init_mlstm_state),
                        (rxl.init_slstm_state, xlstm.init_slstm_state)):
        for r, t in zip(rinit(rcfg, B), init(cfg, B, "cpu")):
            assert t.dtype == torch.float32
            assert np.array_equal(_np(t), np.asarray(r)), type(r)
    assert xlstm.d_inner(cfg) == rxl.d_inner(rcfg)


def test_mlstm_step_matches_reference():
    """One step from a random state (``m`` finite)."""
    (rq, rk, rv, ri, rf), (tq, tk, tv, ti, tf) = _gates(1, 0)
    rng = np.random.default_rng(1)
    c, n, m = (rng.normal(0, 1, (B, 2, 16, 16)), rng.normal(0, 1, (B, 2, 16)),
               rng.normal(0, 1, (B, 2)))
    want, rh = rxl._mlstm_step(
        rxl.MLSTMState(*(jnp.asarray(a, jnp.float32) for a in (c, n, m))),
        (rq[:, 0], rk[:, 0], rv[:, 0], ri[:, 0], rf[:, 0]))
    got, th = xlstm._mlstm_step(
        xlstm.MLSTMState(_t(c), _t(n), _t(m)),
        (tq[:, 0], tk[:, 0], tv[:, 0], ti[:, 0], tf[:, 0]))
    np.testing.assert_allclose(_np(th), _np(rh), rtol=F32_TOL, atol=F32_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL)


@functools.lru_cache(maxsize=None)
def _reference_forms(s):
    """The reference's recurrent and chunkwise (h [B, S, NH, DH], state)
    on ``_gates(s, s)``."""
    (rargs, _), (s0, _) = _gates(s, s), _zero_state()
    st_rec, h_rec = jax.jit(rxl._mlstm_recurrent)(*rargs, s0)
    st_chk, h_chk = jax.jit(rxl._mlstm_chunkwise)(*rargs, s0)
    return (np.asarray(h_rec).reshape(B, s, 2, 16), st_rec), (h_chk, st_chk)


@pytest.mark.parametrize("s", [64, 128])
@pytest.mark.parametrize("form", ["recurrent", "chunkwise"])
def test_mlstm_forms_match_reference(form, s):
    """Each form against the reference's same form, and the chunkwise
    against the reference's recurrent, on float32 inputs."""
    (_, targs), (_, t0) = _gates(s, s), _zero_state()
    rec, chk = _reference_forms(s)
    st, h = getattr(xlstm, f"_mlstm_{form}")(*targs, t0)
    assert h.shape == (B, s, 2, 16)
    for want in ({"recurrent": rec, "chunkwise": chk}[form], rec):
        np.testing.assert_allclose(_np(h), _np(want[0]), rtol=F32_TOL,
                                   atol=F32_TOL)
        for g, w in zip(st, want[1]):
            np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL,
                                       atol=F32_TOL)


def test_chunkwise_state_handoff_to_decode():
    """Chunkwise over 128 steps, then one recurrent step: the recurrent
    pass's h at step 128 (the reference's
    ``test_chunkwise_state_handoff_to_decode``), and the reference's step
    from its own chunkwise state."""
    s = 128
    (rargs, targs), (r0, t0) = _gates(s + 1, 3), _zero_state()
    _, h_full = xlstm._mlstm_recurrent(*targs, t0)
    st, _ = xlstm._mlstm_chunkwise(*(a[:, :s] for a in targs), t0)
    _, h_last = xlstm._mlstm_step(st, tuple(a[:, s] for a in targs))
    np.testing.assert_allclose(_np(h_last), _np(h_full[:, s]), rtol=F32_TOL,
                               atol=F32_TOL)
    rst, _ = rxl._mlstm_chunkwise(*(a[:, :s] for a in rargs), r0)
    _, rh = rxl._mlstm_step(rst, tuple(a[:, s] for a in rargs))
    np.testing.assert_allclose(_np(h_last), _np(rh), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("s", [100, 129])
def test_mlstm_ragged_s_against_recurrent(s):
    """A ragged S, which the reference's chunkwise form refuses: chunks of
    64 and a last partial one, against the port's recurrent form."""
    (rargs, targs), (r0, t0) = _gates(s, 10 + s), _zero_state()
    with pytest.raises(AssertionError):
        rxl._mlstm_chunkwise(*rargs, r0)
    st_chk, h_chk = xlstm._mlstm_chunkwise(*targs, t0)
    st_rec, h_rec = xlstm._mlstm_recurrent(*targs, t0)
    np.testing.assert_allclose(_np(h_chk), _np(h_rec), rtol=F32_TOL,
                               atol=F32_TOL)
    for g, w in zip(st_chk, st_rec):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("s", [64, 128])
def test_mlstm_forward_matches_reference(s):
    """bfloat16 in and out, with the final state handed back."""
    rcfg, cfg = _cfgs()
    p, tp = _params(rxl.init_mlstm, 1)
    rx, tx = _x(s, 2)
    want, rst = rxl.mlstm_forward(p, rx, rcfg, rxl.init_mlstm_state(rcfg, B))
    got, st = xlstm.mlstm_forward(tp, tx, cfg,
                                  xlstm.init_mlstm_state(cfg, B, "cpu"))
    assert got.dtype == torch.bfloat16 and got.shape == (B, s, cfg.d_model)
    _rows(got, want, RTOL, f"mlstm_forward S {s}")
    for g, w in zip(st, rst):
        _within(g, w, RTOL, f"mlstm state S {s}")


@pytest.mark.parametrize("s", [64, 128])
def test_slstm_forward_matches_reference(s):
    """The whole sLSTM in float32, its output cast to bfloat16; the
    input projection hoisted out of the loop."""
    rcfg, cfg = _cfgs()
    p, tp = _params(rxl.init_slstm, 3)
    assert all(v.dtype == torch.float32 for v in tp.values())
    rx, tx = _x(s, 4)
    want, rst = rxl.slstm_forward(p, rx, rcfg, rxl.init_slstm_state(rcfg, B))
    got, st = xlstm.slstm_forward(tp, tx, cfg,
                                  xlstm.init_slstm_state(cfg, B, "cpu"))
    assert got.dtype == torch.bfloat16
    _rows(got, want, RTOL, f"slstm_forward S {s}")
    for g, w in zip(st, rst):
        _within(g, w, RTOL, f"slstm state S {s}")
    # the reference's step, its projection inside, on the port's state
    st1, h1 = xlstm._slstm_step(tp, cfg, st, tx[:, 0].float())
    rst1, rh1 = rxl._slstm_step(p, rcfg, rst, rx[:, 0].astype(jnp.float32))
    _within(h1, rh1, RTOL, "slstm step")


def test_slstm_ragged_s():
    """S 129, which the reference's reshape into equal chunks refuses: the
    first 128 rows equal the port's forward at S 128, and the last one
    its decode step from that run's state."""
    rcfg, cfg = _cfgs()
    p, tp = _params(rxl.init_slstm, 5)
    rx, tx = _x(129, 6)
    with pytest.raises(TypeError):
        rxl.slstm_forward(p, rx, rcfg)
    got = xlstm.slstm_forward(tp, tx, cfg)
    head, st = xlstm.slstm_forward(tp, tx[:, :128], cfg,
                                   xlstm.init_slstm_state(cfg, B, "cpu"))
    assert torch.equal(got[:, :128], head)
    last, _ = xlstm.slstm_decode(tp, tx[:, 128:], cfg, st)
    _rows(got[:, 128:], last, RTOL, "S 129's last row against decode")


# -- the model -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models():
    """(reference model, its params, the port's CPU model with them)."""
    ref = rbuild(_cfgs()[0])
    params = ref.init(jax.random.key(0))
    port = build_model(_cfgs()[1], device="cpu")
    load_reference(port, params)
    return ref, params, port


def _tokens(s, seed):
    tok = np.random.default_rng(seed).integers(0, 512, (B, s),
                                               dtype=np.int32)
    return {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}


def _state_close(got, want, i, what):
    """Layer i's state against the reference's stacked cache (group 0 of
    ``pos{i}``): each tensor within ``STATE_TOL`` of its largest
    |value|."""
    ref = want[f"pos{i}"]
    assert type(got).__name__ == type(ref).__name__
    for g, w in zip(got, ref):
        _within(g, w[0], STATE_TOL, f"{what} {type(got).__name__}")


def test_layers_match_reference():
    """Each layer fed the reference's own residual stream (the embedded
    tokens, then each reference layer's output): within ``_rows``' 2e-2.
    The ``none`` channel has no ``ln2``, no ``ffn`` and no residual."""
    ref, params, port = _models()
    rb, _ = _tokens(64, 9)
    x = jnp.take(params["embed"], rb["tokens"], axis=0)
    pos = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (B, 64))
    for i, layer in enumerate(port.layers):
        assert blocks.layer_kind(port.cfg, i)[1] == "none"
        assert not hasattr(layer, "ln2") and not hasattr(layer, "ffn")
        rp = jax.tree.map(lambda a: a[0], params["blocks"][f"pos{i}"])
        want, _ = rblocks.apply_train(rp, x, ref.cfg, i, pos)
        with torch.no_grad():
            got, aux = blocks.apply_train(layer, _t(x).bfloat16(), port.cfg,
                                          i, torch.from_numpy(np.array(
                                              pos)))
        assert aux is None
        _rows(got, want, RTOL, f"layer {i}")
        x = want


def test_forward_logits_and_loss():
    ref, params, port = _models()
    rb, tb = _tokens(64, 1)
    want, _ = jax.jit(ref.forward)(params, rb)
    with torch.no_grad():
        got, aux = port.forward(tb)
    assert got.shape == (B, 64, port.cfg.vocab) and got.dtype == torch.bfloat16
    assert float(aux) == 0.0
    _rows(got, want, LM_TOL, "forward")
    shape = configs.ShapeSpec("smoke_train", 32, B, "train")
    rloss = jax.jit(ref.loss)(params, rsynthetic(ref, rconfigs.ShapeSpec(
        "smoke_train", 32, B, "train")))
    with torch.no_grad():
        loss = port.loss(synthetic_batch(port, shape))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=2e-3)


@functools.lru_cache(maxsize=None)
def _serve():
    """Prefill of S then STEPS decode steps on both, fed the reference's
    greedy tokens: [((reference logits, caches), (port logits, caches)) a
    step]."""
    ref, params, port = _models()
    rb, tb = _tokens(S, 0)
    rl, rc = jax.jit(ref.prefill, static_argnums=2)(params, rb, S + STEPS)
    ops.reset_launch_counts()
    tl, tc = port.prefill(tb, S + STEPS)
    assert sum(ops.launch_counts().values()) == 0
    steps = [((rl, rc), (tl, [type(c)(*(t.clone() for t in c))
                              for c in tc]))]
    decode = jax.jit(ref.decode_step)
    for t in range(STEPS):
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        rl, rc = decode(params, jnp.asarray(nxt), rc, jnp.int32(S + t))
        tl, tc = port.decode_step(torch.from_numpy(nxt), tc, S + t)
        steps.append(((rl, rc), (tl, tc)))
    return steps


def test_prefill_logits_and_states():
    (rl, rc), (tl, tc) = _serve()[0]
    _rows(tl, rl, LM_TOL, "prefill logits")
    assert [type(c).__name__ for c in tc] == ["MLSTMState"] * 3 + \
        ["SLSTMState"]
    for i, c in enumerate(tc):
        _state_close(c, rc, i, f"layer {i} state")
    assert tc[0].c.shape == (B, 2, 64, 64) and tc[3].h.shape == (B, 2, 32)


def test_decode_steps():
    steps = _serve()
    for t, ((rl, rc), (tl, tc)) in enumerate(steps[1:]):
        _rows(tl, rl, LM_TOL, f"decode step {t}")
    for i, c in enumerate(tc):
        _state_close(c, rc, i, f"layer {i} state after decode")


def test_load_reference_carries_xlstm_leaves():
    """Every parameter equals the reference's leaf through the period-4
    groups (layer i is ``pos{i % 4}``); the gates and the sLSTM stay
    float32; the tied embedding has no ``lm_head``."""
    ref, params, port = _models()
    names = dict(port.named_parameters())
    assert "lm_head" not in names and "layers.0.ln2" not in names
    for k in ("gate_i", "gate_f"):
        assert names[f"layers.1.mixer.{k}"].dtype == torch.float32
    for k in ("wx", "rh", "bias"):
        assert names[f"layers.3.mixer.{k}"].dtype == torch.float32
    assert names["layers.0.mixer.wq"].dtype == torch.bfloat16
    for name, p in names.items():
        want = np.asarray(reference_leaf(params, name, 4), np.float32)
        assert np.array_equal(_np(p), want), name
    ref_leaves = jax.tree.leaves(params)
    assert len(names) == len(ref_leaves)


def test_full_model_modes_agree():
    """The reference's ``test_full_model_modes_agree`` on the port:
    ``MLSTM_MODE`` recurrent against chunkwise within 5e-2."""
    _, _, port = _models()
    batch = synthetic_batch(port, configs.ShapeSpec("t", 64, 2, "train"))
    old = xlstm.MLSTM_MODE
    try:
        with torch.no_grad():
            xlstm.MLSTM_MODE = "recurrent"
            l_rec, _ = port.forward(batch)
            xlstm.MLSTM_MODE = "chunkwise"
            l_chk, _ = port.forward(batch)
    finally:
        xlstm.MLSTM_MODE = old
    np.testing.assert_allclose(_np(l_chk), _np(l_rec), rtol=5e-2, atol=5e-2)


def test_prefill_decode_consistent_with_forward():
    """A prefill of 100 tokens (a ragged S: a chunk of 64 and one of 36)
    and 7 decode steps, each step against the forward's position within
    the reference's rtol = atol = 0.15."""
    _, _, port = _models()
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (B, 108), dtype=np.int32))
    with torch.no_grad():
        full, _ = port.forward({"tokens": tok})
    logits, caches = port.prefill({"tokens": tok[:, :100]})
    outs = [logits]
    for t in range(100, 107):
        logits, caches = port.decode_step(tok[:, t:t + 1], caches, t)
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)),
                               _np(full[:, 99:107]), rtol=0.15, atol=0.15)


def test_train_step_matches_reference():
    """One AdamW step from step 150 (seeded m and v), B 2, S 32."""
    ref, params, port = _models()
    state = rtrain_state_init(ref, jax.random.key(0))
    rng = np.random.default_rng(7)
    m = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1e-3, p.shape), jnp.float32), state.params)
    v = jax.tree.map(lambda p: jnp.asarray(
        1e-6 * rng.uniform(0.5, 1.5, p.shape), jnp.float32), state.params)
    state = RTrainState(state.params, ropt.AdamWState(jnp.int32(MID_STEP),
                                                      m, v))
    tok = rng.integers(0, 512, (B, S + 1), dtype=np.int32)
    rnew, rmet = jax.jit(rmake_train_step(ref, base_lr=BASE_LR))(
        state, {"tokens": jnp.asarray(tok[:, :-1]),
                "labels": jnp.asarray(tok[:, 1:])})
    model = build_model(port.cfg, device="cpu")
    tstate = train_state_from_reference(model, state)
    new, met = make_train_step(model, base_lr=BASE_LR)(tstate, {
        "tokens": torch.from_numpy(tok[:, :-1].copy()),
        "labels": torch.from_numpy(tok[:, 1:].copy())})
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=2e-2)
    lr = float(rmet["lr"])
    for name, p in new.params.items():
        want = np.asarray(reference_leaf(rnew.params, name, 4), np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        err = np.abs(_np(p) - want)
        assert (err <= PARAM_LR_TOL * lr + ulp).all(), (
            f"{name}: max error {err.max():.3g}, lr {lr:.3g}")
        assert new.opt.m[name].dtype == torch.float32
        _within(new.opt.m[name], reference_leaf(rnew.opt.m, name, 4),
                MOMENT_TOL, f"m {name}")


def test_param_count_full_config():
    cfg = configs.get_config(ARCH)
    meta = build_model(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    ref = jax.eval_shape(lambda: rbuild(rconfigs.get_config(ARCH)).init(
        jax.random.key(0)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    assert 0.09e9 <= n <= 0.2e9
    assert dataclasses.replace(cfg).param_count() == \
        rconfigs.get_config(ARCH).param_count()
